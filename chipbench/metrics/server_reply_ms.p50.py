"""Median of the server's own `serve.reply` spans in the window: from the
batch function's return until the request's reply has been sent on the
`responses` topic."""

from chipbench import spans
from chipbench.record import percentile


def read(run):
    return percentile([s.host_ms for s in spans.in_window(run, "serve.reply")], 50)
