"""Tokens a second: G tokens for every request sent in the window, over the
time from the window's first send to its last reply (the drain included)."""


def read(run):
    if run.window_s <= 0 or not run.done:
        return None
    return run.traffic.gen * len(run.done) / run.window_s
