"""The 95th percentile of request latency, send to reply on the `responses`
topic, over every request sent in the window."""

from chipbench.record import latency_p95_ms


def read(run):
    return latency_p95_ms(run)
