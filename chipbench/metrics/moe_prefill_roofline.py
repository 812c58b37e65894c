"""The prompt's expert products against their roofline, read from the
program's spans: the least time they need in every MoE layer at the cell's
shapes (the family file's `moe_prefill_work`: each token's routed and shared
experts, every expert's weights once, over the rows each batch held), over
the device time of the `moe.experts` and `moe.shared` spans inside
`prefill`.  Left out for a family without the count, or a program without
the spans."""

from chipbench import spans
from chipbench.work import least_seconds


def read(run):
    work = getattr(run.family, "moe_prefill_work", None)
    if work is None:
        return None
    need, experts = 0.0, []
    for _, rows, inner in spans.prefills(run):
        need += least_seconds(*work(run.model, rows, run.traffic.prompt_len, run.dtype),
                              run.dtype)
        experts += [s for s in inner if s.name in ("moe.experts", "moe.shared")]
    ms = spans.device_ms(experts) if experts else None
    if not ms or need <= 0:
        return None
    return 100.0 * need / (ms / 1e3)
