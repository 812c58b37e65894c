"""Training driver: the PyTorch counterpart of ``repro/launch/train.py``.

Composes the train step (AdamW, gradients through autograd), the proxy-fed
data pipeline (batches reach the step as proxies and resolve just-in-time),
async proxy-backed checkpointing through the Store's connectors, and restart
from the latest checkpoint.  One device: the mesh flags raise until the
sharding port.  As the JAX driver passes its (n, 1) mesh, the step's
context names an expert-parallel world of one, so an MoE config with
``moe_impl="ep"`` trains through the EP form, capacity drops included.
An encoder-decoder arch (whisper-tiny) is refused up front: the JAX driver's
batches carry no ``frame_embeds`` either.

    python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 200 --batch 8 --seq 256
    python -m repro_torch.launch.train --smoke --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU on its own.  As in the JAX driver, a resumed run's batches begin again
at batch 0.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.api import ConnectorSpec, StoreConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import refuse_encoder_decoder, resolve_device
from repro_torch.models import transformer as tx
from repro_torch.models.moe import ExpertWorld
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import ProxyPrefetcher, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def _check_single_device(args) -> None:
    flags = [f for f, on in (("--production", args.production), ("--multi-pod", args.multi_pod),
                             ("--fsdp-pod", args.fsdp_pod)) if on]
    if flags:
        raise NotImplementedError(
            f"{', '.join(flags)}: needs the mesh and sharding port "
            "(distributed/sharding.py, launch/mesh.py), not ported yet"
        )


def train(args) -> dict[str, Any]:
    _check_single_device(args)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    refuse_encoder_decoder(cfg, "train")
    device = resolve_device(args.device)
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
    step_fn = make_train_step(cfg, opt_cfg, tx.RunCtx(mesh=ExpertWorld()))

    def make_batch(i):
        return synthetic_batch(
            np.random.default_rng(args.seed * 100_003 + i),
            args.batch, args.seq, cfg.vocab_size,
        )

    metrics_log: list[dict] = []
    t_start = t_last = time.perf_counter()
    with ProxyPrefetcher(store, make_batch, depth=args.prefetch) as pf:
        for step, proxy in zip(range(start_step, args.steps), pf):
            batch = {"tokens": bridge.to_tensor(proxy["tokens"], device=device)}
            state, metrics = step_fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])  # waits for the step
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
                ckpt.save(step, state)  # async, off the step path
    ckpt.save(args.steps, state, blocking=True)

    (run_dir / "metrics.json").write_text(json.dumps(metrics_log, indent=1))
    return {"final": metrics_log[-1] if metrics_log else None,
            "log": metrics_log}


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
                    help="the production mesh (not ported yet: raises)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported yet: raises")
    ap.add_argument("--fsdp-pod", action="store_true",
                    help="not ported yet: raises")
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
