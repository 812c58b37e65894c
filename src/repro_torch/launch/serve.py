"""Serving entry point: continuous-batching decode behind the streaming data plane.

The PyTorch counterpart of ``repro/launch/serve.py``.  Requests ride a
stream topic through the port's own :class:`~repro_torch.api.Session`, the
runtime's :class:`~repro_torch.runtime.serving.ModelServer` batches them up
to ``--batch`` within ``--max-wait-ms``, and ``generate`` pads each batch to
the serving width, prefills and decodes greedily.  With
``attention_impl="pallas"`` every prefill goes through the hand-written
kernels: prompt attention through ``flash_attention`` (dense archs), the
prompt's SSD scan through ``ssd_scan`` (mamba2-130m), and both for
hymba-1.5b: the prompt attention of its three global layers through
``flash_attention`` and every layer's SSD scan through ``ssd_scan``.  Its
sliding-window layers attend over the prompt in plain PyTorch and keep their
keys in ring caches of ``window`` slots.  The MoE archs prefill through the
experts' routed form on one device (the dense form on a mesh, since the
context says ``decode=True`` in prefill too, as the JAX driver's does) and
decode through the dense form; kimi-k2's prompt attention and
deepseek-v2-lite's MLA (keys and values expanded per head from the latent)
go through ``flash_attention``, and MLA's decode attends against its latent
cache in plain PyTorch.  An encoder-decoder arch
(whisper-tiny) is refused up front, as the JAX driver serves none of its
requests; ``repro_torch.models.whisper``'s ``prefill``/``decode_step`` serve
it, and ``chip_smoke.py`` drives them.

    python -m repro_torch.launch.serve --arch qwen2.5-3b --batch 4 \
        --prompt-len 1024 --gen 32
    python -m repro_torch.launch.serve --arch mamba2-130m --batch 4 \
        --prompt-len 1024 --gen 32
    python -m repro_torch.launch.serve --arch hymba-1.5b --batch 4 \
        --prompt-len 2048 --gen 32 --requests 8

kimi-k2's config does not fit one card (4.1 TB of f32 params), and the f32
params of deepseek-v2-lite, starcoder2-15b and granite-20b are 62.8, 63.8
and 112.7 GB; ``chip_smoke.py`` serves all four through this module with
bf16 params, kimi cut to 2 layers, the others at full depth.  The other
dense archs (qwen2.5-3b, phi4-mini-3.8b, internvl2-2b) serve as configured;
internvl2-2b's requests are tokens alone, as the JAX driver's are.

The port's tracer (:mod:`repro_torch.runtime.trace`) records the run:
``prefill_s`` is the device time of the ``prefill`` spans (their host time
on the CPU), ``decode_tok_s`` the answer tokens over the host time of the
``decode`` spans (a batch's decode loop up to its synchronize: a step that
replays a CUDA graph returns before its work is done), and the kernels'
launches are the tracer's counters.
``--trace-out PATH`` writes the spans as Chrome-trace JSON, and the run
prints the spans' summary by name.

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU on its own.  ``--run-dir`` serves a training run's latest checkpoint
(``repro_torch.launch.train``): its params resolve by proxy from the run's
store, leaf by leaf, onto the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import bridge
from repro_torch.api import ClusterSpec, ConnectorSpec, ServeSpec, Session, StoreConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import ShardingRules, distribute, gather_full
from repro_torch.launch.mesh import world_mesh
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import transformer as tx
from repro_torch.runtime import trace
from repro_torch.train.checkpoint import CheckpointManager


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU"
        )
    return device


def refuse_encoder_decoder(cfg, driver: str) -> None:
    """The drivers run decoder-only archs, as the JAX drivers do: the JAX
    serve driver prefills through ``transformer`` and serves no whisper
    request, and the JAX train driver makes no ``frame_embeds``."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder arch: repro_torch.launch.{driver} does not "
            f"run it, and neither does the JAX driver repro.launch.{driver}; use "
            "repro_torch.models.whisper (prefill, decode_step) and the train step directly"
        )


def _load_params(args, cfg, device: torch.device):
    """Weights from the checkpoint store (lazy proxies, only the params
    resolved) or fresh random weights from a generator seeded with 0, made
    on the device."""
    if args.run_dir:
        store = StoreConfig(
            f"train-{args.arch}",
            ConnectorSpec("sharded", store_dir=f"{args.run_dir}/objects",
                          num_shards=8),
        ).build(register=True)
        ckpt = CheckpointManager(store, f"{args.run_dir}/ckpt_index.json")
        restored = ckpt.restore_lazy()
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.run_dir}")
        step, lazy = restored
        params = bridge.params_from_jax(lazy.get("params", lazy), device=device)
        print(f"[restore] lazily resolved step-{step} weights by proxy")
        return params
    gen = torch.Generator(device=device).manual_seed(0)
    return tx.init_params(cfg, gen)


@contextlib.contextmanager
def _sharded_step():
    with torch.no_grad(), implicit_replication():
        yield


def _span_seconds(spans: list) -> float:
    """Seconds of the spans: their device time where they recorded it,
    their host time else."""
    total_ms = 0.0
    for s in spans:
        dev = s.device_ms()
        total_ms += s.host_ms if dev is None else dev
    return total_ms / 1e3


def serve(args) -> dict:
    with trace.enabled():
        return _serve(args)


def _serve(args) -> dict:
    cfg = (get_smoke_config if args.smoke else get_config)(
        args.arch, attention_impl="pallas"
    )
    refuse_encoder_decoder(cfg, "serve")
    device = resolve_device(args.device)
    ctx = tx.RunCtx(decode=True)
    params = _load_params(args, cfg, device)
    mesh = world_mesh(device.type)
    B, PL, G = args.batch, args.prompt_len, args.gen
    if mesh is not None:
        rules = ShardingRules(mesh, fsdp_params=False)  # serving layout
        ctx = tx.RunCtx(mesh=mesh, dp_axes=rules.dp_axes, ep_axis="model", decode=True)
        params = distribute(params, rules.state_shardings(params), mesh)
        rows = rules.batch_spec(2) if B % mesh.size(0) == 0 else (None, None)

    n_req = args.requests or 2 * B
    t_start = time.perf_counter_ns()

    def ours(name: str | None) -> list:
        """This run's spans (of ``name`` only)."""
        return [s for s in trace.spans(name) if s.t0 >= t_start]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_batch(toks: np.ndarray) -> np.ndarray:
        """Prefill the padded batch once, step the KV cache: (B, G) tokens.
        With a mesh every rank runs it on its batch rows."""
        cache = tx.init_cache(cfg, B, PL + G + 1, device=device)
        tokens = torch.from_numpy(toks).to(device)
        if mesh is not None:
            cache = distribute(cache, rules.cache_shardings(cache), mesh)
            tokens = distribute(tokens, rows, mesh)
        logits, cache = tx.prefill(cfg, params, tokens, cache, ctx)
        sync()
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        with trace.span("decode"):
            for i in range(G - 1):
                pos = torch.full((B, 1), PL + i, dtype=torch.int64, device=device)
                logits, cache = tx.decode_step(cfg, params, cache, tok, pos, ctx)
                tok = logits[:, -1:].argmax(-1)
                out.append(tok)
            sync()
        return gather_full(torch.cat(out, dim=1)).to(torch.int32).cpu().numpy()

    # with a mesh, rank 0 serves and hands each batch to the other ranks,
    # which run it in step with it (plain tensors made in the step replicated)
    step_mode = torch.inference_mode if mesh is None else _sharded_step

    def generate(prompts: list) -> list:
        """Batched forward for the server: pad to the fixed serving width,
        prefill once, step the KV cache."""
        k = len(prompts)
        toks = np.stack([np.asarray(p, np.int64) for p in prompts])
        if k < B:
            toks = np.concatenate([toks, np.zeros((B - k, PL), np.int64)])
        if mesh is not None:
            dist.broadcast_object_list([toks], src=0)
        with step_mode():
            full = run_batch(toks)
        return [full[i] for i in range(k)]

    if mesh is not None and dist.get_rank() != 0:
        while True:
            batch = [None]
            dist.broadcast_object_list(batch, src=0)
            if batch[0] is None:
                return {"follower": dist.get_rank(), "prefills": len(ours("prefill"))}
            with step_mode():
                run_batch(batch[0])

    spec = ClusterSpec(
        n_workers=1,
        serve=ServeSpec(max_batch_size=B, max_wait_ms=args.max_wait_ms),
    )
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, (PL,)).astype(np.int32) for _ in range(n_req)
    ]
    kernels = {"flash_attention": fa_ops, "ssd_scan": ssd_ops}
    launches0 = {name: trace.counter(ops.LAUNCHES) for name, ops in kernels.items()}
    t_wall = time.perf_counter()
    with Session(cluster=spec, name=f"serve-{args.arch}") as session:
        server = session.serve(generate)
        server.attach(
            session.stream_consumer("requests"),
            session.stream_producer("responses"),
        )
        requests = session.stream_producer("requests")
        responses = session.stream_consumer("responses")

        keys = [requests.send(p) for p in prompts]
        requests.close()  # EOS: the pump flushes and closes the reply topic

        outs = {
            item.metadata["key"]: item.value
            for item in responses
            if item.metadata.get("status") == "ok"
        }
        t_wall = time.perf_counter() - t_wall
        sstats = server.stats()
        hub = session.cluster.streams().stats()
    if mesh is not None:
        dist.broadcast_object_list([None], src=0)  # the followers stop

    assert len(outs) == n_req, f"served {len(outs)}/{n_req} requests"
    prefills = ours("prefill")
    prefill_s = _span_seconds(prefills)
    decode_s = sum(s.host_ms for s in ours("decode")) / 1e3
    tps = n_req * (G - 1) / decode_s if decode_s else 0.0
    launches = {name: trace.counter(ops.LAUNCHES) - launches0[name]
                for name, ops in kernels.items()}
    mine = ours(None)
    summary = trace.summary(mine)
    if args.trace_out:
        trace.export_chrome(args.trace_out, mine)
    print(f"served {n_req} reqs in {sstats['batches']} batches "
          f"(mean {sstats['mean_batch']:.2f}) | prefill {prefill_s:.3f}s "
          f"| decode {tps:,.1f} tok/s | flash launches {launches['flash_attention']} "
          f"| ssd_scan launches {launches['ssd_scan']}")
    print(f"latency p50/p99: {sstats['latency_p50_ms']:.1f}/"
          f"{sstats['latency_p99_ms']:.1f} ms | broker {hub['broker_bytes']:,}B "
          f"vs payload {hub['payload_bytes']:,}B")
    print("spans: " + json.dumps(summary))
    return {
        "prefill_s": prefill_s,
        "decode_tok_s": tps,
        "requests": n_req,
        "wall_s": t_wall,
        "server": sstats,
        "stream": hub,
        "kernel_launches": launches,
        "flash_launches": launches["flash_attention"],
        "prefills": len(prefills),
        "spans": summary,
        "device": str(device),
        "prompts": prompts,
        "outputs": [outs[key] for key in keys],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="serving batch width (ServeSpec.max_batch_size)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="dynamic batcher window (ServeSpec.max_wait_ms)")
    ap.add_argument("--requests", type=int, default=0,
                    help="request count (default: 2x batch)")
    ap.add_argument("--run-dir", default="",
                    help="restore weights from this train run's store")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--trace-out", default="",
                    help="write the run's spans here as Chrome-trace JSON")
    return ap.parse_args(argv)


if __name__ == "__main__":
    serve(parse_args())
