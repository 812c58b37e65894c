"""Runtime calls that enqueue device work (`cudaLaunchKernel*`,
`cuLaunchKernel*`, `cudaMemcpyAsync`, `cudaMemsetAsync`) a decode step: the
device trace's calls that start inside a `decode_step` span, over the
window's `decode_step` spans."""

from chipbench import spans


def read(run):
    steps = spans.in_window(run, "decode_step")
    if run.trace is None or not steps:
        return None
    n = spans.enqueue_calls_in(run.trace, steps)
    return n / len(steps) if n is not None else None
