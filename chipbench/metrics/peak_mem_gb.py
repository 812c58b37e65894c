"""Peak device memory over the window: `torch.cuda.max_memory_allocated()`
after `reset_peak_memory_stats()` at its start, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes > 0 else None
