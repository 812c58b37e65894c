"""The whole step's share of the card's bf16 dense peak: the FLOPs the
window's requests need (the cell's family file's `request_flops`: the
configuration's shapes, not the program's operations) over the window's time
and 989 TF/s."""

from chipbench.work import PEAK_FLOPS


def read(run):
    if run.window_s <= 0 or not run.done:
        return None
    t = run.traffic
    flops = run.family.request_flops(run.model, t.prompt_len, t.gen) * len(run.done)
    return 100.0 * flops / (run.window_s * PEAK_FLOPS[run.dtype])
