"""The full-attention layers' prompt attention against its roofline, read
from the program's spans: the least time it needs at the cell's shapes
(`chipbench.work.attn_prefill_work`, over the rows each batch held), over
the device time of the `attn.core` spans of window 0 inside `prefill`.  The
span runs from q, k and v in the model's layout to the output back in it,
so whatever kernel computes it, and the layout copies around it, count."""

from chipbench import spans
from chipbench.work import attn_prefill_work, least_seconds


def read(run):
    need, core = 0.0, []
    for _, rows, inner in spans.prefills(run):
        need += least_seconds(*attn_prefill_work(run.model, rows, run.traffic.prompt_len,
                                                 run.dtype), run.dtype)
        core += [s for s in inner if s.name == "attn.core" and s.attrs.get("window") == 0]
    ms = spans.device_ms(core) if core else None
    if not ms or need <= 0:
        return None
    return 100.0 * need / (ms / 1e3)
