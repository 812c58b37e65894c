"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

The PyTorch counterpart of ``repro/launch/dryrun.py``.  Proves the
distribution config is coherent without hardware: ``run_cell`` sets up a
fake process group of 256 or 512 ranks in this one process (``fake_pg`` of
``torch.testing``: collectives return at once), builds the production
``DeviceMesh``, lays out the cell's state and inputs by ``ShardingRules``
as ``DTensor`` leaves whose local shards are ``meta`` tensors (no memory), and
runs the step eagerly under ``implicit_replication`` (plain tensors made
inside the step are replicated) and ``op_analysis.OpCounter`` (rank 0's
per-device program, its collectives included).  Its profile is written to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``, or
``.error.json`` on failure.

Fields as in the reference, with these differences: ``trace_seconds``
replaces ``lower_seconds``/``compile_seconds`` (nothing is compiled);
``memory_analysis`` holds rank 0's argument, output and alias bytes (from
its shards) and ``temp_size_in_bytes``, the peak of the bytes that the
step's ops allocated and held at once (the counter's ``peak_bytes``, the
outputs it made included).  ``CommDebugMode`` would count the same
collectives (the tests hold the two counts equal) but doubles the trace
time of a long prefill, so the dry-run leaves it out.
``generated_code_size_in_bytes``
and ``hlo_bytes`` have no meaning without a compiler and are left out.
Importing this module creates no process group.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --all            # every cell, resumable
    python -m repro_torch.launch.dryrun --all --subprocess   # one process per cell
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _fake_group(world: int) -> bool:
    """A fake process group of ``world`` ranks (rank 0); True if made here."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return False
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    return True


def _local_shape(shape, pl, mesh) -> list[int]:
    out = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide mesh dim {i}")
            out[p.dim] //= mesh.size(i)
    return out


def distribute_abstract(tree: Any, specs: Any, mesh) -> Any:
    """Meta stand-ins -> ``DTensor`` leaves laid out by ``specs``, with meta shards."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    if isinstance(tree, dict):
        return {k: distribute_abstract(v, specs[k], mesh) for k, v in tree.items()}
    pl = placements(specs, mesh)
    local = torch.empty(_local_shape(tree.shape, pl, mesh), dtype=tree.dtype, device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=tree.shape,
                              stride=tree.stride())


def _leaves(tree: Any) -> list:
    from torch.utils._pytree import tree_flatten

    return tree_flatten(tree)[0]


def _locals(tree: Any) -> list:
    """Rank 0's tensors of a tree: each ``DTensor`` leaf's local shard."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in _leaves(tree)]


def _nbytes(ts: list) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _lay_out(tree: Any, specs: Any, mesh) -> Any:
    """Outputs laid out as the cell's out specs say (``out_shardings``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements
    from repro_torch.models.common import as_dtensor, relayout

    if isinstance(tree, dict):
        return {k: _lay_out(v, specs if isinstance(specs, tuple) else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lay_out(t, s, mesh) for t, s in zip(tree, specs))
    if not isinstance(tree, DTensor):
        tree = as_dtensor(tree, mesh)
    spec = specs if len(specs) == tree.ndim else (None,) * tree.ndim
    return relayout(tree, placements(spec, mesh))


def run_cell(arch: str, shape: str, mesh_kind: str, overrides: dict | None = None, *,
             mesh_shape: tuple[int, ...] | None = None, smoke: bool = False,
             comm_debug: bool = False) -> dict:
    """One cell.  ``mesh_shape`` (tests) replaces the production mesh with a
    fake one of that shape over the same axis names, ``smoke`` the config
    with the arch's smoke config, and ``comm_debug`` adds ``CommDebugMode``'s
    counts of collectives by op (``comm_counts``); none is on the CLI."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpCounter

    skip = specs_mod.cell_skip_reason(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "skipped": skip}

    # overrides prefixed "shard:" steer ShardingRules; the rest is ModelConfig
    overrides = dict(overrides or {})
    shard_kw = {
        k.split(":", 1)[1]: v for k, v in overrides.items() if k.startswith("shard:")
    }
    overrides = {k: v for k, v in overrides.items() if not k.startswith("shard:")}

    multi = mesh_kind == "multi"
    if mesh_shape is None:
        made = _fake_group(512 if multi else 256)
    else:
        made = _fake_group(math.prod(mesh_shape))
    try:
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh

            axes = ("pod", "data", "model") if multi else ("data", "model")
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=axes)
        rules = ShardingRules(mesh, **shard_kw)
        cell = specs_mod.make_cell(arch, shape, rules, overrides, smoke=smoke)
        args = tuple(distribute_abstract(a, s, mesh)
                     for a, s in zip(cell.args, cell.in_shardings))
        arg_locals = _locals(args)
        arg_ids = {t.untyped_storage()._cdata for t in arg_locals}

        counter = OpCounter(skip_fake=True)
        t0 = time.monotonic()
        grad = contextlib.nullcontext() if cell.meta["kind"] == "train" else torch.no_grad()
        comm = CommDebugMode() if comm_debug else contextlib.nullcontext()
        with counter, comm, implicit_replication(), grad:
            out = cell.step_fn(*args)
            out = _lay_out(out, cell.out_shardings, mesh)
        t_trace = time.monotonic() - t0
        out_locals = _locals(out)
        analysis = counter.analyze()
        coll = {k: v for k, v in analysis["collectives"].items() if k != "total"}
        coll["count"] = analysis["collective_count"]
        return {
            "arch": arch,
            "shape": shape,
            "mesh": mesh_kind,
            "devices": int(mesh.size()),
            "mesh_shape": dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape))),
            "meta": cell.meta,
            "trace_seconds": round(t_trace, 2),
            "memory_analysis": {
                "argument_size_in_bytes": _nbytes(arg_locals),
                "output_size_in_bytes": _nbytes(out_locals),
                "alias_size_in_bytes": _nbytes(
                    [t for t in out_locals if t.untyped_storage()._cdata in arg_ids]),
                "temp_size_in_bytes": counter.peak_bytes,
            },
            "cost_analysis": {
                "flops": analysis["flops"],
                "transcendentals": analysis["transcendental_elems"],
                "bytes accessed": analysis["bytes"],
            },
            "collectives": coll,
            "hlo_analysis": analysis,
            "top_contributors": counter.top_contributors(10),
            "overrides": {**overrides, **{f"shard:{k}": v for k, v in shard_kw.items()}},
            **({"comm_counts": {str(k): int(v) for k, v in comm.get_comm_counts().items()}}
               if comm_debug else {}),
        }
    finally:
        if made:
            dist.destroy_process_group()


def _artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> Path:
    suffix = f"__{tag}" if tag else ""
    return ARTIFACTS / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh interpreter (bounded memory)")
    ap.add_argument("--overrides", type=json.loads, default=None,
                    help='JSON dict of ModelConfig overrides (perf experiments)')
    ap.add_argument("--tag", default="", help="artifact suffix for experiments")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    ARTIFACTS.mkdir(parents=True, exist_ok=True)

    if args.all:
        from repro_torch.configs import list_archs
        from repro_torch.launch.specs import SHAPES

        cells = [
            (a, s, m)
            for a in list_archs()
            for s in SHAPES
            for m in ("single", "multi")
        ]
        failures = 0
        for arch, shape, mesh_kind in cells:
            path = _artifact_path(arch, shape, mesh_kind)
            if path.exists() and not args.force:
                print(f"[skip-cached] {path.name}")
                continue
            if args.subprocess:
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                ]
                if args.force:
                    cmd.append("--force")
                print(f"[cell] {arch} x {shape} x {mesh_kind} ...", flush=True)
                rc = subprocess.call(cmd)
                failures += rc != 0
            else:
                rc = _run_and_write(arch, shape, mesh_kind, None, "")
                failures += rc != 0
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required unless --all")
    return _run_and_write(args.arch, args.shape, args.mesh, args.overrides, args.tag,
                          force=args.force)


def _run_and_write(arch, shape, mesh_kind, overrides, tag, force=False, **cell_kw) -> int:
    path = _artifact_path(arch, shape, mesh_kind, tag)
    if path.exists() and not force and not overrides:
        print(f"[skip-cached] {path.name}")
        return 0
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.monotonic()
        result = run_cell(arch, shape, mesh_kind, overrides, **cell_kw)
        result["wall_seconds"] = round(time.monotonic() - t0, 2)
        path.write_text(json.dumps(result, indent=1))
        if "skipped" in result:
            print(f"[SKIP] {arch} x {shape} x {mesh_kind}: {result['skipped']}")
        else:
            ca = result["cost_analysis"]
            print(
                f"[OK] {arch} x {shape} x {mesh_kind}: "
                f"flops={ca.get('flops', 0):.3e} "
                f"trace={result['trace_seconds']}s"
            )
        return 0
    except Exception as exc:  # noqa: BLE001 - report and record the failure
        traceback.print_exc()
        path.with_suffix(".error.json").write_text(
            json.dumps({"arch": arch, "shape": shape, "mesh": mesh_kind,
                        "error": f"{type(exc).__name__}: {exc}"})
        )
        return 1


if __name__ == "__main__":
    sys.exit(main())
