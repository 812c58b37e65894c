"""The batcher thread's CPU time over wall time in the window's
`decode_step` spans, summed over them: well under 100 means a step waits
for the interpreter lock or a CPU, not for its own Python."""

from chipbench import spans


def read(run):
    steps = [s for s in spans.in_window(run, "decode_step") if s.cpu_ms is not None]
    wall = sum(s.host_ms for s in steps)
    return 100.0 * sum(s.cpu_ms for s in steps) / wall if wall > 0 else None
