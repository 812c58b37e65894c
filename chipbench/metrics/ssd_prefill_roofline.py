"""K2's share of its roofline in the window: the least time of the prompt's
SSD scans in every layer at the cell's shapes (`chipbench.work.
ssd_prefill_work`, over the rows the batches held), over the device time of
the kernels that ran them.  The port's K2 kernels are found by name."""

from chipbench.work import least_seconds, ssd_prefill_work

#: kernel names of kernels/ssd_scan (csrc/ssd_scan.cu)
KERNELS = ("ssd_scan_bf16", "ssd_scan_f32", "sum_tiles")


def read(run):
    if run.trace is None or run.model["family"] != "hybrid":
        return None
    spent = run.trace.op_seconds(KERNELS)
    if spent <= 0:
        return None
    need = sum(least_seconds(*ssd_prefill_work(run.model, b.rows, run.traffic.prompt_len,
                                               run.dtype), run.dtype)
               for b in run.batches)
    return 100.0 * need / spent if need > 0 else None
