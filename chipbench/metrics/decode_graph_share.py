"""Share of the window's `decode_step` spans that replayed a captured CUDA
graph (their `graph` attribute reads "replay"); left out where the steps
carry no `graph` attribute (a program that captures none)."""

from chipbench import spans


def read(run):
    modes = [s.attrs.get("graph") for s in spans.in_window(run, "decode_step")]
    if not modes or None in modes:
        return None
    return 100.0 * modes.count("replay") / len(modes)
