"""The windowed layers' prompt attention against its roofline: the least
time it needs at the cell's shapes (`chipbench.window_work`: 4 H hd FLOPs
for each (query, key) pair inside the window, q, k, v and o once, over the
rows each batch held), over the device time of the `attn.core` spans with
a window inside `prefill`."""

from chipbench import spans
from chipbench.window_work import window_attn_prefill_work
from chipbench.work import least_seconds


def read(run):
    need, core = 0.0, []
    for _, rows, inner in spans.prefills(run):
        need += least_seconds(*window_attn_prefill_work(
            run.model, rows, run.traffic.prompt_len, run.dtype), run.dtype)
        core += [s for s in inner if s.name == "attn.core" and s.attrs.get("window", 0) > 0]
    ms = spans.device_ms(core) if core else None
    if not ms or need <= 0:
        return None
    return 100.0 * need / (ms / 1e3)
