"""Seconds from the process's start to the window's first send: imports,
weights made on the device, kernels loaded (built in a first run), the
session and one warm batch of the cell's shapes."""


def read(run):
    return run.setup_s
