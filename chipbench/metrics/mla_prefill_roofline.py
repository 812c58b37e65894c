"""The prompt's latent attention against its roofline, read from the
program's spans: the least time it needs in every layer at the cell's true
widths (the family file's `mla_prefill_work`: the latent's up-projections
and 2 H (qk + v) FLOPs per causal pair, over the rows each batch held),
over the device time of the `attn.core` spans of window 0 inside `prefill`.
Whatever pads the widths for a kernel shows as lost share.  Left out for a
family without the count."""

from chipbench import spans
from chipbench.work import least_seconds


def read(run):
    work = getattr(run.family, "mla_prefill_work", None)
    if work is None:
        return None
    need, core = 0.0, []
    for _, rows, inner in spans.prefills(run):
        need += least_seconds(*work(run.model, rows, run.traffic.prompt_len, run.dtype),
                              run.dtype)
        core += [s for s in inner if s.name == "attn.core" and s.attrs.get("window") == 0]
    ms = spans.device_ms(core) if core else None
    if not ms or need <= 0:
        return None
    return 100.0 * need / (ms / 1e3)
