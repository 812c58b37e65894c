"""Median time from the batch function's return to the client's receipt of
the reply on the `responses` topic."""

from chipbench.record import percentile


def read(run):
    batch = run.batch_of()
    return percentile([(r.t_recv - batch[r.index].t_exit) * 1e3
                       for r in run.done if r.index in batch], 50)
