"""Mean host time of a batch's `prefill` up to `torch.cuda.synchronize()`,
over the window's batches."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.t_prefilled - b.t_prefill for b in run.batches) / len(run.batches)
