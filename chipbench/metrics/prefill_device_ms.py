"""Mean device time of a `prefill` span in the window: from the event the
program records on the stream at `prefill`'s entry to the one at its
return, read after the window."""

from chipbench import spans


def read(run):
    found = spans.in_window(run, "prefill")
    ms = spans.device_ms(found) if found else None
    return ms / len(found) if ms else None
