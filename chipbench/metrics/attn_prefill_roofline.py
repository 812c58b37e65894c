"""K1's share of its roofline in the window: the least time the prompt
attention of the full-attention layers needs at the cell's shapes (the
larger of FLOPs / 989 TF/s and bytes / 3.35 TB/s, q, k, v and o counted
once, over the rows the batches held), over the device time of the kernels
that ran it.  The port's K1 kernels are found by name."""

from chipbench.work import attn_prefill_work, least_seconds

#: kernel names of kernels/flash_attention (csrc/flash_attention.cu)
KERNELS = ("fa_fwd_tc", "fa_fwd_wide", "fa_fwd_f32")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.op_seconds(KERNELS)
    if spent <= 0:
        return None
    need = sum(least_seconds(*attn_prefill_work(run.model, b.rows, run.traffic.prompt_len,
                                                run.dtype), run.dtype)
               for b in run.batches)
    return 100.0 * need / spent if need > 0 else None
