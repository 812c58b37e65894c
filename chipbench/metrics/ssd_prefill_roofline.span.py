"""The prompt's SSD scans against their roofline, read from the program's
spans: the least time they need in every layer at the cell's shapes
(`chipbench.work.ssd_prefill_work`, over the rows each batch held), over
the device time of the `ssm.scan` spans inside `prefill`, whatever runs
the scan."""

from chipbench import spans
from chipbench.work import least_seconds, ssd_prefill_work


def read(run):
    if run.model["family"] != "hybrid":
        return None
    need, scans = 0.0, []
    for _, rows, inner in spans.prefills(run):
        need += least_seconds(*ssd_prefill_work(run.model, rows, run.traffic.prompt_len,
                                                run.dtype), run.dtype)
        scans += [s for s in inner if s.name == "ssm.scan"]
    ms = spans.device_ms(scans) if scans else None
    if not ms or need <= 0:
        return None
    return 100.0 * need / (ms / 1e3)
