"""Serving entry point: continuous-batching decode behind the streaming data plane.

The PyTorch counterpart of ``repro/launch/serve.py``.  Requests ride a
stream topic through the port's own :class:`~repro_torch.api.Session`, the
runtime's :class:`~repro_torch.runtime.serving.ModelServer` batches them up
to ``--batch`` within ``--max-wait-ms``, and ``generate`` pads each batch to
the serving width, prefills (prompt attention through the hand-written
flash kernel, ``attention_impl="pallas"``) and decodes greedily.

    python -m repro_torch.launch.serve --arch qwen2.5-3b --batch 4 \
        --prompt-len 1024 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU on its own.  ``--run-dir`` checkpoint restore waits for the checkpoint
slice of the port and raises until then.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import ClusterSpec, ServeSpec, Session
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import transformer as tx


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to serve on the CPU"
        )
    return device


def _load_params(args, cfg, device: torch.device):
    """Fresh random weights from a generator seeded with 0, made on the device."""
    if args.run_dir:
        raise NotImplementedError("--run-dir restore waits for the checkpoint port")
    gen = torch.Generator(device=device).manual_seed(0)
    return tx.init_params(cfg, gen)


def serve(args) -> dict:
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(
        args.arch, attention_impl="pallas"
    )
    ctx = tx.RunCtx(decode=True)
    params = _load_params(args, cfg, device)

    B, PL, G = args.batch, args.prompt_len, args.gen
    n_req = args.requests or 2 * B
    timings = {"prefill_s": 0.0, "decode_s": 0.0, "decoded": 0, "prefills": 0}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def generate(prompts: list) -> list:
        """Batched forward for the server: pad to the fixed serving width,
        prefill once, step the KV cache."""
        k = len(prompts)
        toks = np.stack([np.asarray(p, np.int64) for p in prompts])
        if k < B:
            toks = np.concatenate([toks, np.zeros((B - k, PL), np.int64)])
        cache = tx.init_cache(cfg, B, PL + G + 1, device=device)
        t0 = time.perf_counter()
        logits, cache = tx.prefill(cfg, params, torch.from_numpy(toks).to(device), cache, ctx)
        sync()
        timings["prefill_s"] += time.perf_counter() - t0
        timings["prefills"] += 1
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(G - 1):
            pos = torch.full((B, 1), PL + i, dtype=torch.int64, device=device)
            logits, cache = tx.decode_step(cfg, params, cache, tok, pos, ctx)
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
        sync()
        timings["decode_s"] += time.perf_counter() - t0
        timings["decoded"] += k * (G - 1)
        full = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        return [full[i] for i in range(k)]

    spec = ClusterSpec(
        n_workers=1,
        serve=ServeSpec(max_batch_size=B, max_wait_ms=args.max_wait_ms),
    )
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, (PL,)).astype(np.int32) for _ in range(n_req)
    ]
    launches0 = fa_ops.launch_count
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

    assert len(outs) == n_req, f"served {len(outs)}/{n_req} requests"
    tps = timings["decoded"] / timings["decode_s"] if timings["decode_s"] else 0.0
    launches = fa_ops.launch_count - launches0
    print(f"served {n_req} reqs in {sstats['batches']} batches "
          f"(mean {sstats['mean_batch']:.2f}) | prefill {timings['prefill_s']:.3f}s "
          f"| decode {tps:,.1f} tok/s | flash launches {launches}")
    print(f"latency p50/p99: {sstats['latency_p50_ms']:.1f}/"
          f"{sstats['latency_p99_ms']:.1f} ms | broker {hub['broker_bytes']:,}B "
          f"vs payload {hub['payload_bytes']:,}B")
    return {
        "prefill_s": timings["prefill_s"],
        "decode_tok_s": tps,
        "requests": n_req,
        "wall_s": t_wall,
        "server": sstats,
        "stream": hub,
        "flash_launches": launches,
        "prefills": timings["prefills"],
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
                    help="restore weights from this train run's store "
                         "(not ported yet: raises)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    serve(parse_args())
