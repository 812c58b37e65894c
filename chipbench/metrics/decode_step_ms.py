"""Host time of the decode loop up to `torch.cuda.synchronize()`, divided by
its steps (G - 1 a batch), over the window's batches."""


def read(run):
    steps = len(run.batches) * (run.traffic.gen - 1)
    if steps <= 0:
        return None
    return 1e3 * sum(b.t_decoded - b.t_prefilled for b in run.batches) / steps
