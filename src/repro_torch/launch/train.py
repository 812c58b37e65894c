"""Training driver: the PyTorch counterpart of ``repro/launch/train.py``.

Composes the train step (AdamW, gradients through autograd), the proxy-fed
data pipeline (batches reach the step as proxies and resolve just-in-time),
async proxy-backed checkpointing through the Store's connectors, and restart
from the latest checkpoint.

The mesh (``build_mesh``): ``--production`` (and ``--multi-pod``) is the
production mesh of 256 (512) ranks; otherwise, in an initialised process
group of n > 1 ranks, an (n, 1) mesh over ("data", "model"), as the JAX
driver's; at one rank there is no mesh, since a one-device mesh shards
nothing.  With a mesh the state is laid out by ``ShardingRules`` (FSDP over
``data``, ``--fsdp-pod`` folds in ``pod``) as ``DTensor`` leaves, the batch by
``batch_spec(2)``, and the step runs under ``implicit_replication``; a
checkpoint gathers the state whole and rank 0 saves it, so ``restore`` and
``serve --run-dir`` read the same manifest.  At one rank the step's context
names an expert-parallel world of one, as the JAX driver's (1, 1) mesh
does, so an MoE config with ``moe_impl="ep"`` trains through the EP form,
capacity drops included.  An encoder-decoder arch (whisper-tiny) is refused
up front: the JAX driver's batches carry no ``frame_embeds`` either.

    python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 200 --batch 8 --seq 256
    python -m repro_torch.launch.train --smoke --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU on its own.  As in the JAX driver, a resumed run's batches begin again
at batch 0.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import bridge
from repro_torch.api import ConnectorSpec, StoreConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import ShardingRules, distribute, gather_full
from repro_torch.launch.mesh import make_production_mesh, world_mesh
from repro_torch.launch.serve import refuse_encoder_decoder, resolve_device
from repro_torch.models import transformer as tx
from repro_torch.models.moe import ExpertWorld
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import ProxyPrefetcher, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def build_mesh(args, device: torch.device) -> DeviceMesh | None:
    if args.production:
        return make_production_mesh(multi_pod=args.multi_pod, device_type=device.type)
    return world_mesh(device.type)


def train(args) -> dict[str, Any]:
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    refuse_encoder_decoder(cfg, "train")
    device = resolve_device(args.device)
    mesh = build_mesh(args, device)
    rank0 = mesh is None or dist.get_rank() == 0
    if args.num_microbatches:
        cfg = cfg.replace(num_microbatches=args.num_microbatches)
    if args.remat:
        cfg = cfg.replace(remat=args.remat)

    # -- store / checkpoint / data (the paper's layer) ------------------------
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    if args.connector == "sharded":
        spec = ConnectorSpec("sharded", store_dir=str(run_dir / "objects"),
                             num_shards=8)
    else:
        spec = ConnectorSpec("memory", segment=f"train-{args.arch}")
    store = StoreConfig(f"train-{args.arch}", spec).build(register=True)
    ckpt = CheckpointManager(store, str(run_dir / "ckpt_index.json"),
                             keep=args.keep_checkpoints)

    # -- state: fresh or restored (crash/preemption restart) -------------------
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    start_step = 0
    restored = ckpt.restore()
    if restored is not None and not args.fresh:
        start_step, tree = restored
        state = bridge.params_from_jax(tree, device=device)
        print(f"[restore] resumed from step {start_step}", flush=True)
    else:
        state = init_train_state(cfg, torch.Generator(device=device).manual_seed(args.seed))
    if mesh is None:
        ctx = tx.RunCtx(mesh=ExpertWorld())
        lay_out = lambda tree, spec: tree  # noqa: E731
    else:
        rules = ShardingRules(mesh, fsdp_pod=args.fsdp_pod)
        ctx = tx.RunCtx(mesh=mesh, dp_axes=rules.dp_axes, ep_axis="model")
        lay_out = functools.partial(distribute, mesh=mesh)
        state = lay_out(state, rules.state_shardings(state))
    step_fn = make_train_step(cfg, opt_cfg, ctx)
    replicated = implicit_replication if mesh is not None else contextlib.nullcontext

    def make_batch(i):
        return synthetic_batch(
            np.random.default_rng(args.seed * 100_003 + i),
            args.batch, args.seq, cfg.vocab_size,
        )

    metrics_log: list[dict] = []
    t_start = t_last = time.perf_counter()
    with ProxyPrefetcher(store, make_batch, depth=args.prefetch) as pf:
        for step, proxy in zip(range(start_step, args.steps), pf):
            tokens = bridge.to_tensor(proxy["tokens"], device=device)
            batch = {"tokens": tokens if mesh is None
                     else lay_out(tokens, rules.batch_spec(tokens.dim()))}
            with replicated():
                state, metrics = step_fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(gather_full(metrics["loss"]))  # waits for the step
                now = time.perf_counter()
                tok_s = (step - start_step + 1) * args.batch * args.seq / (now - t_start)
                print(
                    f"[step {step:5d}] loss={loss:.4f} "
                    f"tokens/s={tok_s:,.0f}", flush=True,
                )
                metrics_log.append({"step": step, "loss": loss, "tokens_per_s": tok_s,
                                    "seconds_since_last_log": now - t_last})
                t_last = now
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                _save(ckpt, step, state, rank0)  # async, off the step path
    _save(ckpt, args.steps, state, rank0, blocking=True)

    if rank0:
        (run_dir / "metrics.json").write_text(json.dumps(metrics_log, indent=1))
    return {"final": metrics_log[-1] if metrics_log else None,
            "log": metrics_log}


def _save(ckpt: CheckpointManager, step: int, state, rank0: bool, **kw) -> None:
    """A sharded state is gathered whole on every rank (a collective) and
    saved by rank 0 alone; a plain one is saved as it is."""
    full = gather_full(state)
    if rank0:
        ckpt.save(step, full, **kw)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--production", action="store_true",
                    help="use the 16x16 production mesh (needs a process group "
                         "of 256 ranks; 512 with --multi-pod)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp-pod", action="store_true")
    ap.add_argument("--num-microbatches", type=int, default=0)
    ap.add_argument("--remat", default="")
    ap.add_argument("--connector", choices=["memory", "sharded"],
                    default="sharded")
    ap.add_argument("--run-dir", default="artifacts/train_run")
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-checkpoints", type=int, default=3)
    ap.add_argument("--fresh", action="store_true", help="ignore checkpoints")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    train(parse_args())
