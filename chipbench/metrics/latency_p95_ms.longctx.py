"""The long-context cell's latency tail, kept beside its rate: its window
holds too few batches for the tail to judge a change."""

from chipbench.record import latency_p95_ms


def read(run):
    return latency_p95_ms(run)
