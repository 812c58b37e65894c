"""H100 roofline of the dry-run: the port's cells priced beside the reference's.

The counterpart of ``benchmarks/roofline.py``, which prices the JAX
package's artifacts at a TPU's rates.  This module reads JSON only (no
JAX, no process group), so it runs wherever the artifacts are: the
port's ``artifacts/dryrun_torch/`` and, where it holds the same cell, the
reference's ``artifacts/dryrun/`` (``scripts/reference_dryrun.py``).

Rates, per GPU (NVIDIA H100 SXM5 data sheet):

* ``PEAK_FLOPS``   989 TF/s, bf16 dense on the tensor cores;
* ``HBM_BW``       3.35 TB/s, HBM3;
* ``LINK_BW``      50 GB/s: the collective rate, an assumption.  A DGX H100
  holds 8 GPUs, each with one 400 Gb/s InfiniBand NDR port (ConnectX-7).
  The dry-run's (16, 16) mesh has 256 GPUs, 32 nodes, so every ``model``
  group of 16 spans two nodes, and a ring over it runs at the slowest
  link's rate: 50 GB/s a GPU a direction.
* ``NVLINK_BW``    450 GB/s a direction (NVLink 4, 900 GB/s both ways): the
  rate if a collective stayed inside one node, the second column.

A cell's terms are its per-device counts over these rates, from each
artifact's ``hlo_analysis`` (matrix-product FLOPs, bytes, collective output
bytes, trip-count-corrected on both sides): ``compute`` = FLOPs /
``PEAK_FLOPS``, ``memory`` = bytes / ``HBM_BW``, ``collective`` =
collective bytes / the link rate.  The memory term does not compare across
the two sides: the port counts every eager ATen op's operands and result
(nothing fused), the reference XLA's fused CPU HLO, so the port's term is
an upper bound.  The verdict between the two programs therefore uses
``compute + collective`` only (``step_seconds``).

Usage::

    python -m repro_torch.launch.roofline              # the table, text
    python -m repro_torch.launch.roofline --markdown   # every column, markdown
    python -m repro_torch.launch.roofline --summary    # PERF.md's table
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
PORT = ROOT / "artifacts" / "dryrun_torch"
REFERENCE = ROOT / "artifacts" / "dryrun"

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
NVLINK_BW = 450e9

# the same-work band: per-device FLOPs within 10 %, argument bytes within 5 %
FLOP_BAND = (0.90, 1.10)
ARG_BAND = 0.05
# the port's compute + collective time may exceed the reference's by this
SLOWER_LIMIT = 1.25


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time one card takes for ``flops`` and ``nbytes``: the
    larger of the compute and memory terms."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def terms(cell: dict, link_bw: float = LINK_BW) -> dict:
    """The roofline terms (seconds) of one artifact, its dominant term and
    ``step_seconds`` = compute + collective."""
    h = cell["hlo_analysis"]
    t = {
        "compute": h["flops"] / PEAK_FLOPS,
        "memory": h["bytes"] / HBM_BW,
        "collective": h["collectives"]["total"] / link_bw,
    }
    t["dominant"] = max(("compute", "memory", "collective"), key=t.get)
    t["step_seconds"] = t["compute"] + t["collective"]
    return t


def _load(path: Path) -> dict | None:
    if not path.exists():
        return None
    cell = json.loads(path.read_text())
    return None if "skipped" in cell else cell


def compare(port: dict, ref: dict | None) -> dict:
    """One row: both sides' counts and prices, the ratios and the verdict.

    ``same_work``: FLOPs within ``FLOP_BAND`` and argument bytes within
    ``ARG_BAND`` of the reference's.  ``verdict``: "port faster" when its
    compute + collective time is the smaller, "within 1.25x" when it is at
    most ``SLOWER_LIMIT`` times the reference's, else "reference faster"."""
    pt, pn = terms(port), terms(port, NVLINK_BW)
    row = {
        "arch": port["arch"], "shape": port["shape"], "mesh": port["mesh"],
        "flops": port["hlo_analysis"]["flops"],
        "args": port["memory_analysis"]["argument_size_in_bytes"],
        "coll": port["hlo_analysis"]["collectives"]["total"],
        "port": pt, "port_nvlink": pn["step_seconds"],
    }
    if ref is None:
        return row
    rt, rn = terms(ref), terms(ref, NVLINK_BW)
    ref_flops = ref["hlo_analysis"]["flops"]
    ref_args = ref["memory_analysis"]["argument_size_in_bytes"]
    row.update({
        "ref_flops": ref_flops, "ref_args": ref_args,
        "ref_coll": ref["hlo_analysis"]["collectives"]["total"],
        "ref": rt, "ref_nvlink": rn["step_seconds"],
        "flop_ratio": row["flops"] / ref_flops if ref_flops else float("inf"),
        "arg_ratio": row["args"] / ref_args if ref_args else float("inf"),
        "time_ratio": pt["step_seconds"] / rt["step_seconds"],
    })
    row["same_work"] = (FLOP_BAND[0] <= row["flop_ratio"] <= FLOP_BAND[1]
                        and abs(row["arg_ratio"] - 1) <= ARG_BAND)
    if row["time_ratio"] <= 1:
        row["verdict"] = "port faster"
    elif row["time_ratio"] <= SLOWER_LIMIT:
        row["verdict"] = "within 1.25x"
    else:
        row["verdict"] = "reference faster"
    return row


def table(port_dir: Path = PORT, ref_dir: Path = REFERENCE) -> list[dict]:
    """A row for every kept cell of ``port_dir``, in file-name order."""
    rows = []
    for path in sorted(port_dir.glob("*.json")):
        if path.name.endswith(".error.json"):
            continue
        port = _load(path)
        if port is not None:
            rows.append(compare(port, _load(ref_dir / path.name)))
    return rows


def _ms(s: float) -> str:
    return f"{s * 1e3:.4g}"


def format_row(r: dict, markdown: bool = False) -> str:
    p = r["port"]
    cells = [f"{r['arch']} {r['shape']} {r['mesh']}",
             f"{r['flops']:.3e}", f"{r['coll'] / 1e9:.4g}",
             f"{_ms(p['compute'])} / {_ms(p['memory'])} / {_ms(p['collective'])}",
             p["dominant"], _ms(p["step_seconds"]), _ms(r["port_nvlink"])]
    if "ref" in r:
        q = r["ref"]
        cells += [f"{r['ref_flops']:.3e}", f"{r['ref_coll'] / 1e9:.4g}",
                  f"{r['flop_ratio']:.3f}", f"{r['arg_ratio']:.3f}",
                  _ms(q["step_seconds"]), _ms(r["ref_nvlink"]),
                  f"{r['time_ratio']:.3g}", r["verdict"] + (" (same work)" if r["same_work"]
                                                            else "")]
    else:
        cells += ["no reference cell"] + [""] * 7
    return "| " + " | ".join(cells) + " |" if markdown else "  ".join(cells)


def summary_rows(rows: list[dict]) -> list[str]:
    """PERF.md's table: a line for each arch x shape, its single-pod and
    multi-pod cells side by side (``‖``): FLOPs and argument bytes, port /
    reference with their ratio, both programs' compute + collective ms and
    the verdict."""
    def side(r: dict, key: str) -> str:
        return {"flops": f"{r['flops']:.3e} / {r['ref_flops']:.3e} ({r['flop_ratio']:.3f})",
                "args": f"{r['args'] / 1e9:.4g} / {r['ref_args'] / 1e9:.4g} ({r['arg_ratio']:.3f})",
                "ms": f"{_ms(r['port']['step_seconds'])} / {_ms(r['ref']['step_seconds'])}",
                "verdict": r["verdict"] + (", same work" if r["same_work"] else "")}[key]

    cells: dict = {}
    for r in rows:
        if "ref" in r:
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = []
    for (arch, shape), by_mesh in cells.items():
        pair = [by_mesh[m] for m in ("single", "multi") if m in by_mesh]
        out.append(f"| {arch} {shape} | " + " | ".join(
            " ‖ ".join(side(r, k) for r in pair) for k in ("flops", "args", "ms", "verdict"))
            + " |")
    return out


SUMMARY_HEADER = ("| cell (single ‖ multi) | FLOP a device, port / ref (ratio) | argument GB, "
                  "port / ref (ratio) | compute + collective ms, port / ref | verdict |")

HEADER = ["cell", "port FLOP", "port coll GB", "port compute / memory (upper bound) / "
          "collective ms", "dominant", "port step ms", "port step ms, NVLink",
          "ref FLOP", "ref coll GB", "FLOP ratio", "arg ratio", "ref step ms",
          "ref step ms, NVLink", "time ratio", "verdict"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=Path, default=PORT)
    ap.add_argument("--reference", type=Path, default=REFERENCE)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="the compact table of PERF.md (cells with a reference only)")
    args = ap.parse_args(argv)
    rows = table(args.port, args.reference)
    if not rows:
        print(f"no artifacts under {args.port}", file=sys.stderr)
        return 1
    print(f"H100 rates: {PEAK_FLOPS / 1e12:g} TF/s bf16, {HBM_BW / 1e12:g} TB/s HBM3, "
          f"collectives {LINK_BW / 1e9:g} GB/s (InfiniBand NDR) or "
          f"{NVLINK_BW / 1e9:g} GB/s (NVLink 4); step = compute + collective")
    if args.summary:
        print(SUMMARY_HEADER)
        print("|" + " --- |" * (SUMMARY_HEADER.count(" | ") + 1))
        print("\n".join(summary_rows(rows)))
        return 0
    if args.markdown:
        print("| " + " | ".join(HEADER) + " |")
        print("|" + " --- |" * len(HEADER))
    else:
        print("  ".join(HEADER))
    for r in rows:
        print(format_row(r, args.markdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
