#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. Build every kernel from ``csrc/`` and hold each wrapper against its plain
   PyTorch version on the card: flash attention over the kernel test shapes
   x {float32, bfloat16} (tolerance 2e-4 / 2e-2, plus a per-row relative L2
   limit) and at qwen2.5-3b's serving prefill geometry, where two planted
   faults must be rejected.  Times the kernel, the plain version and one
   PyTorch library call at that geometry for the ``kernels`` line.
2. Model checks: the smoke config on the card against the same weights on
   the CPU (prefill and decode logits), then the full-width qwen2.5-3b
   ``forward`` with the flash kernel, block by block no further from an
   f32-compute forward than the chunked reference is (the same two planted
   faults must fail this check too); then a breakdown of the
   serving decode step (host time, device kernel time, bound).
3. Serve: ``repro_torch.launch.serve`` at full qwen2.5-3b width behind
   ``Session``/``ModelServer``.  Launch counts are set to 0 just before and
   read just after; every kernel of the path must have launched.

The last lines are the ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs the repository's
``src/`` beside this file and a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# (B, H, KV, Sq, Skv, hd, causal): the kernel test shapes of the JAX package
FA_SHAPES = [
    (1, 4, 4, 64, 64, 32, True),
    (1, 4, 2, 64, 64, 32, True),
    (2, 8, 1, 96, 96, 64, True),
    (1, 4, 4, 33, 33, 16, True),
    (1, 2, 2, 128, 256, 64, False),
    (1, 2, 1, 8, 512, 128, False),
    (1, 16, 4, 160, 160, 128, True),
]
# Kernel against plain version: elementwise |out - ref| <= tol + tol * |ref|
# (the JAX kernel sweep's tolerances), and for every query row the relative
# L2 error over (B, H, hd) within ROW_REL_TOL, so that a fault confined to a
# few late rows, whose outputs are small, cannot hide under the first limit.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
ROW_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
KV_TILE = 32  # keys per kv tile of the kernel (kBK in flash_attention.cu)
# Full-width bf16 forward: over every block of KV_TILE tokens, the flash
# path's relative L2 distance from an f32-compute forward is at most
# FORWARD_NOISE times the reference path's
FORWARD_NOISE = 1.25
# Planted faults each check must reject: a kernel that ignores the causal
# mask, and one that skips the last kv tile of the sequence
FAULTS = ("non-causal", "last kv tile skipped")
SERVE_ARGS = ["--arch", "qwen2.5-3b", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--requests", "8", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(out, ref, dname: str) -> tuple[float, float, bool, bool]:
    """Max abs error and worst per-row relative L2 error of (B, H, Sq, hd)
    outputs, and whether each is within its limit."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    err = diff.abs().max().item()
    within = bool((diff.abs() <= TOL[dname] + TOL[dname] * ref.abs()).all())
    rows = lambda t: t.movedim(2, 0).reshape(t.shape[2], -1)  # noqa: E731
    row_rel = (rows(diff).norm(dim=1) / rows(ref).norm(dim=1).clamp_min(1e-30)).max().item()
    return err, row_rel, within, row_rel <= ROW_REL_TOL[dname]


def plant_fault(flash, fault: str, q_axis: int):
    """``flash(q, k, v, causal=...)`` with a fault planted: the causal mask
    ignored, or the last kv tile skipped (its rows then see only the keys
    before it).  ``q_axis`` is the sequence axis of q, k and v."""

    def faulty(q, k, v, *, causal):
        if fault == "non-causal":
            return flash(q, k, v, causal=False)
        t = q.shape[q_axis] - KV_TILE
        head = lambda x, a, b: x.narrow(q_axis, a, b - a)  # noqa: E731
        out = flash(q, k, v, causal=causal).clone()
        tail = flash(head(q, t, q.shape[q_axis]), head(k, 0, t), head(v, 0, t), causal=False)
        head(out, t, q.shape[q_axis]).copy_(tail)
        return out

    return faulty


def phase_kernels(gen) -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t0 = time.perf_counter()
    lib = fa_kernel.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s")
    for line in fa_kernel.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, KV, Sq, Skv, hd, causal in FA_SHAPES:
            q = randn(B, H, Sq, hd, dtype=dtype)
            k = randn(B, KV, Skv, hd, dtype=dtype)
            v = randn(B, KV, Skv, hd, dtype=dtype)
            out = flash_attention_gqa(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            shape = (B, H, KV, Sq, Skv, hd, causal)
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"flash {shape} {dname}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
            err, row_rel, *oks = compare(out, ref, dname)
            print(f"[flash] {dname} {shape} max_abs_err {err:.3e} (tol {TOL[dname]}) "
                  f"row rel_l2 {row_rel:.3e} (tol {ROW_REL_TOL[dname]})")
            if not all(oks):
                fail(f"flash {shape} {dname}: kernel disagrees with the plain version")

    # qwen2.5-3b serving prefill: q/k/v reach the kernel as the model's
    # transposed views of (B, S, KV, G, hd) and (B, S, KV, hd)
    B, H, KV, S, hd = 4, 16, 2, 1024, 128
    G = H // KV
    dtype = torch.bfloat16
    q = randn(B, S, KV, G, hd, dtype=dtype).permute(0, 2, 3, 1, 4).reshape(B, H, S, hd)
    k = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
    v = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
    out = flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, row_rel, *oks = compare(out, ref, "bfloat16")
    print(f"[flash] prefill bf16 (B={B}, H={H}, KV={KV}, S={S}, hd={hd}, causal) "
          f"max_abs_err {err:.3e} (tol {TOL['bfloat16']}) "
          f"row rel_l2 {row_rel:.3e} (tol {ROW_REL_TOL['bfloat16']})")
    if not all(oks):
        fail("flash prefill geometry: kernel disagrees with the plain version")
    for fault in FAULTS:
        bad = plant_fault(flash_attention_gqa, fault, 2)(q, k, v, causal=True)
        b_err, b_row, b_within, b_row_ok = compare(bad, ref, "bfloat16")
        verdict = lambda ok: "passed" if ok else "rejected"  # noqa: E731
        print(f"[flash] planted fault '{fault}': max_abs_err {b_err:.3e} "
              f"({verdict(b_within)}) row rel_l2 {b_row:.3e} ({verdict(b_row_ok)})")
        if b_within and b_row_ok:
            fail(f"the kernel check does not see the planted fault '{fault}'")

    ms = time_ms(lambda: flash_attention_gqa(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True))
    k_rep = k.repeat_interleave(G, dim=1)
    v_rep = v.repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k_rep, v_rep, is_causal=True))
    lib_err = (sdpa(q, k_rep, v_rep, is_causal=True).float() - ref.float()).abs().max().item()
    print(f"[flash] sdpa yardstick max_abs_err vs plain {lib_err:.3e}")

    pairs = S * (S + 1) // 2  # (q, k) pairs with k <= q, per (b, h)
    flops = 4 * hd * pairs * B * H  # Q K^T and P V, 2 FLOPs per multiply-add
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"[flash] prefill: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms"
          f" | bound {max(t_ops, t_bytes):.4f} ms ({flops:.4e} FLOP, {nbytes} B)")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def phase_model() -> dict:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention
    from repro_torch.models import transformer as tx

    real_flash = attention._flash
    # smoke config, f32: the card (flash prefill) against the CPU reference
    cfg = get_smoke_config("qwen2.5-3b")
    params_cpu = tx.init_params(cfg, torch.Generator().manual_seed(0))
    params_gpu = _to(params_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    worst = 0.0
    with torch.inference_mode():
        caches = {d: tx.init_cache(cfg, 2, 48, device=d) for d in ("cpu", "cuda")}
        lc, caches["cpu"] = tx.prefill(cfg, params_cpu, toks, caches["cpu"])
        lg, caches["cuda"] = tx.prefill(cfg.replace(attention_impl="pallas"), params_gpu,
                                        toks.cuda(), caches["cuda"])
        for i in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            tok = lc[:, -1:].argmax(-1)
            pos = torch.full((2, 1), 40 + i, dtype=torch.int64)
            lc, caches["cpu"] = tx.decode_step(cfg, params_cpu, caches["cpu"], tok, pos)
            lg, caches["cuda"] = tx.decode_step(cfg, params_gpu, caches["cuda"], tok.cuda(),
                                                pos.cuda())
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
    print(f"[model] smoke f32 prefill+decode logits, card vs CPU: max_abs_err {worst:.3e} (tol 1e-3)")
    if not worst <= 1e-3:
        fail("smoke model on the card disagrees with the CPU")

    # full width, bf16 compute: flash forward against the chunked reference
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] qwen2.5-3b full width: {n_params:,} params "
          f"({n_params * 4 / 1e9:.2f} GB f32) made in {time.perf_counter() - t0:.1f}s")
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    pcfg = cfg.replace(attention_impl="pallas")
    with torch.inference_mode():
        ref, _, _ = tx.forward(cfg.replace(attention_impl="reference"), params, toks)
        exact, _, _ = tx.forward(cfg.replace(compute_dtype=torch.float32), params, toks)
        n0 = fa_ops.launch_count
        out, _, _ = tx.forward(pcfg, params, toks)
        torch.cuda.synchronize()
        n = fa_ops.launch_count - n0
        planted = {}
        for fault in FAULTS:
            attention._flash = plant_fault(real_flash, fault, 1)
            try:
                planted[fault], _, _ = tx.forward(pcfg, params, toks)
            finally:
                attention._flash = real_flash

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def block_rel(a, b):
        """Relative L2 error over each block of KV_TILE tokens of (B, S, d)."""
        blocks = lambda t: t.float().unflatten(1, (-1, KV_TILE)).transpose(0, 1).flatten(1)  # noqa: E731
        return (blocks(a) - blocks(b)).norm(dim=1) / blocks(b).norm(dim=1)

    # Through 36 random-weight layers the bf16 rounding noise itself is a
    # few 1e-2 of relative L2, so the flash path is held to the reference
    # path's own distance from the f32 forward, block by block
    noise = block_rel(ref, exact)
    ratio = (block_rel(out, exact) / noise).max().item()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[model] full-width forward (B=1, S=1024), bf16: flash vs reference max_abs_err "
          f"{err:.3e} rel_l2 {rel(out, ref):.3e} | against the f32-compute forward: reference "
          f"rel_l2 {rel(ref, exact):.3e} (blocks {noise.min().item():.3e}-{noise.max().item():.3e})"
          f", flash rel_l2 {rel(out, exact):.3e}, worst block ratio {ratio:.3f} "
          f"(tol {FORWARD_NOISE}) | flash launches {n}")
    if out.shape != (1, 1024, cfg.d_model) or not bool(torch.isfinite(out).all()):
        fail("full-width forward: wrong shape or non-finite values")
    for fault, bad in planted.items():
        b_ratio = (block_rel(bad, exact) / noise).max().item()
        print(f"[model] planted fault '{fault}': rel_l2 vs f32 forward {rel(bad, exact):.3e}, "
              f"worst block ratio {b_ratio:.3f} -> {'PASSED' if b_ratio <= FORWARD_NOISE else 'rejected'}")
        if b_ratio <= FORWARD_NOISE:
            fail(f"the forward check does not see the planted fault '{fault}'")
    if n != cfg.num_layers or ratio > FORWARD_NOISE:
        fail("full-width forward: flash path disagrees with the reference")
    del ref, exact, out, planted
    decode = decode_breakdown(tx, cfg, params)
    del params
    torch.cuda.empty_cache()
    return decode


def decode_breakdown(tx, cfg, params) -> dict:
    """Serving decode step at batch 4 after a 1024-token prefill, outside the
    server: host time per step, device kernel time per step from the
    profiler, and the step's bound from the bytes it must move."""
    B, PL, steps = 4, 1024, 8
    pcfg = cfg.replace(attention_impl="pallas")
    toks = torch.randint(0, cfg.vocab_size, (B, PL), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        cache = tx.init_cache(cfg, B, PL + 2 * steps + 8, device="cuda")
        logits, cache = tx.prefill(pcfg, params, toks, cache)
        tok = logits[:, -1:].argmax(-1)
        pos = [PL]

        def step():
            nonlocal tok, cache
            p = torch.full((B, 1), pos[0], dtype=torch.int64, device="cuda")
            lg, cache = tx.decode_step(pcfg, params, cache, tok, p)
            tok = lg[:, -1:].argmax(-1)
            pos[0] += 1

        step()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    dev_us = sum(e.self_device_time_total for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # bytes a step must move as the port runs it: every f32 matrix is read,
    # cast to bf16 (written) and read again; f32 vectors read once
    n_mat = sum(t.numel() for t in _leaves(params) if t.dim() >= 2)
    n_vec = sum(t.numel() for t in _leaves(params) if t.dim() < 2)
    step_bytes = n_mat * (4 + 2 + 2) + n_vec * 4
    bf16_bytes = n_mat * 2 + n_vec * 4  # bf16 weights kept on the card, read once
    res = {
        "host_ms_per_step": host_ms,
        "device_ms_per_step": dev_us / 1e3 if dev_us else None,
        "bound_ms_as_run": step_bytes / PEAK_BYTES * 1e3,
        "bound_ms_bf16_weights": bf16_bytes / PEAK_BYTES * 1e3,
        "top_kernels": [(e.key[:80], e.self_device_time_total / steps / 1e3) for e in top],
    }
    busy = f"{res['device_ms_per_step']:.3f} ms" if dev_us else "not measured"
    print(f"[decode] B={B} after S={PL}: {host_ms:.3f} ms/step on the host clock | device "
          f"kernels {busy}/step | bound as run {res['bound_ms_as_run']:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB), with bf16 weights {res['bound_ms_bf16_weights']:.3f} ms")
    for name, ms in res["top_kernels"]:
        print(f"[decode]   {ms:.4f} ms/step  {name}")
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import parse_args, serve

    args = parse_args(SERVE_ARGS)
    cfg = get_config(args.arch)
    fa_ops.launch_count = 0  # counts of the main path only
    res = serve(args)
    launches = fa_ops.launch_count
    sstats = res["server"]
    print(f"[serve] {res['requests']} requests, {sstats['batches']} batches, "
          f"{res['prefills']} prefills | prefill {res['prefill_s']:.4f}s | "
          f"decode {res['decode_tok_s']:.2f} tok/s | latency p50 {sstats['latency_p50_ms']:.2f} ms "
          f"p99 {sstats['latency_p99_ms']:.2f} ms | flash launches {launches}")
    outs = res["outputs"]
    if len(outs) != 8:
        fail(f"served {len(outs)}/8 requests")
    for o in outs:
        if o.shape != (args.gen,) or o.min() < 0 or o.max() >= cfg.vocab_size:
            fail(f"bad generation {o}")
    if launches < cfg.num_layers * res["prefills"] or launches == 0:
        fail(f"flash kernel launched {launches} times for {res['prefills']} prefills")
    return {"launches": launches, **{k: res[k] for k in ("prefill_s", "decode_tok_s", "prefills")},
            "latency_p50_ms": sstats["latency_p50_ms"], "latency_p99_ms": sstats["latency_p99_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 3
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fa = phase_kernels(gen)
    print(f"[phase 1] kernels ok ({time.perf_counter() - t0:.1f}s)")
    decode = phase_model()
    print(f"[phase 2] model ok ({time.perf_counter() - t0:.1f}s)")
    served = phase_serve()
    fa["launches"] = served["launches"]
    print(f"[phase 3] serve ok ({time.perf_counter() - t0:.1f}s)")

    gpu = gpu_name_and_limit()
    result = {"kernels": [fa]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({**result, "serve": served, "decode": decode, "gpu": gpu}, indent=1)
    )
    print(json.dumps(result))
    print(gpu)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
