"""The JAX package's dry-run, run as it is on JAX 0.9.

``repro.launch.dryrun`` builds its production mesh with ``jax.make_mesh``
and no ``axis_types`` (``repro/launch/mesh.py``).  From JAX 0.9 that makes
``Explicit`` axes, and every cell then fails at its first
``with_sharding_constraint`` ("can only refer to Auto axes").  This script
patches ``jax.make_mesh`` in its own process to give ``AxisType.Auto`` axes,
the axes the package was written for, and runs the package's ``run_cell``
unchanged.  The package's module sets its 512-device ``XLA_FLAGS`` when it
is imported, so it is imported before anything touches a JAX backend.

Each cell's artifact (``<arch>__<shape>__<mesh>.json``, ``.error.json`` on
failure) holds ``run_cell``'s fields plus ``top_contributors``: the 25
largest instructions of the compiled HLO, from the package's own
``hlo_analysis.top_contributors``, so GSPMD's layout can be read from the
file, and ``async_collective_starts``: the HLO's ``*-start`` collectives,
whose ``-done`` halves the package's ``collective_bytes`` counts again
(its ``hlo_analysis`` counts each pair once).

Usage::

    python scripts/reference_dryrun.py --arch mamba2-130m --shape decode_32k --mesh single
    python scripts/reference_dryrun.py --all                # the 80 cells, resumable
    python scripts/reference_dryrun.py --cells plan.json --out DIR
        # plan.json: [{"arch", "shape", "mesh", "cut": 8, "overrides": {...}}, ...];
        # "cut" divides the shape's sequence length for that cell only

Artifacts go to ``artifacts/dryrun/`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS before JAX starts)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.launch import hlo_analysis, specs  # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, **kw)


jax.make_mesh = _auto_mesh

_ASYNC_START = re.compile(
    r"\b(?:all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)-start\(")
_analyze = hlo_analysis.analyze
_last_hlo: list[str] = []


def _analyze_and_keep(text: str):
    _last_hlo[:] = [text]
    return _analyze(text)


hlo_analysis.analyze = _analyze_and_keep


def run_cell(arch: str, shape: str, mesh: str, *, cut: int = 1,
             overrides: dict | None = None) -> dict:
    """The package's ``run_cell``, with ``SHAPES[shape]``'s sequence divided
    by ``cut`` for this call and the HLO's top contributors added."""
    info = specs.SHAPES[shape]
    specs.SHAPES[shape] = {**info, "seq": info["seq"] // cut}
    _last_hlo.clear()
    try:
        res = dryrun.run_cell(arch, shape, mesh, overrides)
    finally:
        specs.SHAPES[shape] = info
    if _last_hlo:
        res["top_contributors"] = hlo_analysis.top_contributors(_last_hlo[0], 25)
        res["async_collective_starts"] = len(_ASYNC_START.findall(_last_hlo[0]))
    if cut != 1:
        res["cut"] = cut
    return res


def write_cell(out: Path, arch: str, shape: str, mesh: str, *, cut: int = 1,
               overrides: dict | None = None, force: bool = False) -> int:
    path = out / f"{arch}__{shape}__{mesh}.json"
    if path.exists() and not force:
        print(f"[skip-cached] {path.name}", flush=True)
        return 0
    try:
        t0 = time.monotonic()
        res = run_cell(arch, shape, mesh, cut=cut, overrides=overrides)
        res["wall_seconds"] = round(time.monotonic() - t0, 2)
        path.write_text(json.dumps(res, indent=1))
        if "skipped" in res:
            print(f"[SKIP] {arch} x {shape} x {mesh}", flush=True)
        else:
            print(f"[OK] {arch} x {shape} x {mesh}: "
                  f"flops={res['hlo_analysis']['flops']:.3e} "
                  f"compile={res['compile_seconds']}s", flush=True)
        return 0
    except Exception as exc:  # noqa: BLE001 - report and record the failure
        traceback.print_exc()
        path.with_suffix(".error.json").write_text(json.dumps(
            {"arch": arch, "shape": shape, "mesh": mesh,
             "error": f"{type(exc).__name__}: {exc}"}))
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--cut", type=int, default=1,
                    help="divide the shape's sequence length by this")
    ap.add_argument("--overrides", type=json.loads, default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--all", action="store_true", help="every arch x shape x mesh")
    ap.add_argument("--cells", type=Path, help="a JSON list of cells (see the docstring)")
    ap.add_argument("--out", type=Path, default=dryrun.ARTIFACTS)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)

    if args.all:
        from repro.configs import list_archs

        plan = [{"arch": a, "shape": s, "mesh": m}
                for a in list_archs() for s in specs.SHAPES for m in ("single", "multi")]
    elif args.cells:
        plan = json.loads(args.cells.read_text())
    elif args.arch and args.shape:
        plan = [{"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                 "cut": args.cut, "overrides": args.overrides}]
    else:
        ap.error("--arch and --shape, --cells or --all")
    failures = 0
    for c in plan:
        failures += write_cell(args.out, c["arch"], c["shape"], c["mesh"],
                               cut=c.get("cut", 1), overrides=c.get("overrides"),
                               force=args.force)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
