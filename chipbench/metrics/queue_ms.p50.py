"""Median wait of a request before the batch function takes it: client
send to the entry of the batch that holds it."""

from chipbench.record import percentile


def read(run):
    batch = run.batch_of()
    return percentile([(batch[r.index].t_enter - r.t_send) * 1e3
                       for r in run.done if r.index in batch], 50)
