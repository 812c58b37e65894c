"""Median of the server's own `serve.queue` spans in the window: a
request's wait from `ModelServer.submit` to the start of the batch that
holds it."""

from chipbench import spans
from chipbench.record import percentile


def read(run):
    return percentile([s.host_ms for s in spans.in_window(run, "serve.queue")], 50)
