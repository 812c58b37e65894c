"""Flash attention in the PyTorch port against the JAX package, on the CPU.

The port's plain version (``ref.attention_ref``) and its wrapper on CPU
tensors (``ops.flash_attention_gqa``) take the same numpy inputs as the JAX
oracle and the JAX Pallas kernel (interpret mode, as the JAX tests run it).
Tolerances are the JAX kernel sweep's: 2e-4 in float32, 2e-2 in bfloat16
(one bf16 rounding of outputs near 1); float16, which the sweep does not
run, 5e-3 (chip_smoke's TOL: a quarter of bfloat16's, for a mantissa of 10
bits, not 7).  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``; here ``meta`` tensors show what the wrapper
hands its launcher (the head-dim pad, the dtype) and the pure functions
``kernel_route`` and ``check_contract`` state what the launcher takes.  The
sliding window, which the JAX kernel lacks, is held to the JAX package's
``chunked_attention`` at the same window, the mask it replaces.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_gqa as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.runtime import trace

torch.set_num_threads(1)

FA_SHAPES = [
    # (B, H, KV, Sq, Skv, hd, causal): the JAX kernel sweep's shapes
    (1, 4, 4, 64, 64, 32, True),       # MHA
    (1, 4, 2, 64, 64, 32, True),       # GQA 2:1
    (2, 8, 1, 96, 96, 64, True),       # MQA
    (1, 4, 4, 33, 33, 16, True),       # ragged seq
    (1, 2, 2, 128, 256, 64, False),    # cross-ish, non-causal
    (1, 2, 1, 8, 512, 128, False),     # short q, long kv
    (1, 16, 4, 160, 160, 128, True),   # multi-block q and kv
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the kernel's contract past the sweep: head dims with an instance (80, 96,
# 256) and padded ones (72 -> 80), each in three dtypes
CONTRACT_HDS = [72, 80, 96, 256]
CONTRACT_DTYPES = {**DTYPES, "float16": (jnp.float16, torch.float16)}
CONTRACT_TOL = {**TOL, "float16": 5e-3}


def _inputs(shape, seed=0):
    B, H, KV, Sq, Skv, hd, _ = shape
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=s).astype(np.float32)
        for s in [(B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)]
    )


def _both(arrs, dname):
    jdt, tdt = CONTRACT_DTYPES[dname]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_plain_version_matches_jax_oracle(shape, dname):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape), dname)
    causal = shape[-1]
    out = attention_ref(tq, tk, tv, causal=causal)
    ref = jax_ref(jq, jk, jv, causal=causal)
    assert out.shape == tuple(ref.shape) and out.dtype == DTYPES[dname][1]
    _close(out, ref, TOL[dname])


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_wrapper_on_cpu_matches_jax_kernel(shape, dname):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, seed=1), dname)
    causal = shape[-1]
    trace.reset_counts(fa_ops.LAUNCHES)
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    assert out.shape == tuple(ref.shape) and out.dtype == DTYPES[dname][1]
    _close(out, ref, TOL[dname])
    assert trace.counter(fa_ops.LAUNCHES) == 0  # CPU tensors never launch the kernel


def test_custom_scale_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs((1, 2, 2, 64, 64, 32, True), seed=2), "float32")
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=True, scale=0.5)
    _close(out, jax_flash(jq, jk, jv, causal=True, scale=0.5), 2e-4)
    _close(out, jax_ref(jq, jk, jv, causal=True, scale=0.5), 2e-4)


def test_default_scale_is_inverse_sqrt_head_dim():
    _, (tq, tk, tv) = _both(_inputs((1, 2, 1, 16, 16, 32, True), seed=3), "float32")
    a = fa_ops.flash_attention_gqa(tq, tk, tv)
    b = fa_ops.flash_attention_gqa(tq, tk, tv, causal=True, scale=32**-0.5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_heads_must_divide_into_kv_groups():
    q, k = torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        fa_ops.flash_attention_gqa(q, k, k)


def test_kernel_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention_fwd(q, q, q, causal=True, scale=1.0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(fa_kernel, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa_kernel.build()
    assert not (tmp_path / "build").exists()


def test_kernel_source_targets_hopper():
    src = fa_kernel.SOURCE.read_text()
    assert 'extern "C" int repro_fa_fwd' in src
    assert "arch=compute_90a,code=sm_90a" in fa_kernel.NVCC_FLAGS
    assert fa_kernel.HEAD_DIMS == (16, 32, 64, 80, 96, 128, 256)
    # the wgmma instructions are spelled from the element type's tag: both
    # products in bf16 and f16, S = Q K^T over 128- and 64-key tiles, P V at
    # every head dim
    assert "wgmma.mma_async" in src and '"k16.f32." #TY "." #TY' in src
    for tag in ("bf16", "f16"):
        assert f"WGMMA_SS({tag}, 128, 64," in src and f"WGMMA_SS({tag}, 64, 32," in src
        assert f"WGMMA_RS_ALL({tag})" in src
    for hd in fa_kernel.HEAD_DIMS:
        assert f"case {hd}: return Launch<{hd}>::run" in src
        assert f"WGMMA_RS(TY, {hd}, {hd // 2}," in src
    assert "cp.async.bulk.tensor.4d" in src and "mbarrier.arrive.expect_tx" in src
    # the tensor-map encoder comes from the driver through the runtime, so
    # the library is built with the flags every kernel shares
    assert "cuTensorMapEncodeTiled" in src and "cudaGetDriverEntryPoint" in src


def _rand(*shape, dtype):
    return torch.from_numpy(np.random.default_rng(4).normal(size=shape).astype(np.float32)).to(dtype)


def _model_views(B, H, KV, S, hd, dtype, device="cpu"):
    """q, k and v as ``models/attention.py::_flash`` hands them to the kernel."""
    q = _rand(B, S, KV, H // KV, hd, dtype=dtype).to(device)
    kv = _rand(B, S, KV, hd, dtype=dtype).to(device)
    return q.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd), kv.transpose(1, 2), kv.transpose(1, 2)


@pytest.mark.parametrize("dtype, code", [(torch.bfloat16, 1), (torch.float32, 0),
                                         (torch.float16, 2)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_args_route_by_dtype_and_keep_model_strides(dtype, code, device):
    """What reaches ``repro_fa_fwd_window``: the dtype code picks the kernel
    (bfloat16 wgmma + TMA, float32 scalar) and the model's permuted and
    transposed views arrive with their own strides, uncopied."""
    B, H, KV, S, hd = 2, 8, 2, 48, 32
    q, k, v = _model_views(B, H, KV, S, hd, dtype, device)
    assert fa_kernel.kernel_inputs(q, k, v) == (q, k, v)
    out = torch.empty((B, H, S, hd), dtype=dtype, device=device)
    args = fa_kernel.kernel_args(q, k, v, out)
    assert args[:7] == (code, B, H, KV, S, S, hd)
    assert args[7:10] == (S * H * hd, hd, H * hd)          # q: sequence stride H*hd
    assert args[10:13] == args[13:16] == (S * KV * hd, hd, KV * hd)
    assert args[16:] == (H * S * hd, S * hd, hd)


def test_kernel_args_give_unit_dims_a_tma_stride():
    """A dim of length 1 is never stepped over: its stride is sent as hd,
    whatever the view says."""
    q = torch.zeros(1, 2, 5, 16, dtype=torch.bfloat16).as_strided((1, 2, 1, 16), (3, 80, 7, 1))
    k = torch.zeros(1, 1, 5, 16, dtype=torch.bfloat16)
    args = fa_kernel.kernel_args(q, k, k, q)
    assert args[7:10] == (16, 80, 16) and args[10:13] == (16, 16, 16)


def _misaligned_base(dtype):
    return _rand(2 * 4 * 8 * 32 + 1, dtype=dtype)[1:].view(2, 4, 8, 32)


def _odd_sequence_stride(dtype):
    return _rand(2, 4, 8, 33, dtype=dtype)[..., :32]


def _head_broadcast(dtype):
    return _rand(2, 1, 8, 32, dtype=dtype).expand(2, 4, 8, 32)


def _odd_unit_strides(dtype):
    return _rand(1, 4, 1, 32, dtype=dtype).as_strided((1, 4, 1, 32), (5, 32, 3, 1))


@pytest.mark.parametrize("make, copied", [
    (lambda dt: _model_views(2, 8, 2, 48, 32, dt)[0], False),
    (lambda dt: _model_views(2, 8, 2, 48, 32, dt)[1], False),
    (lambda dt: _rand(2, 4, 8, 32, dtype=dt), False),
    (_odd_unit_strides, False),
    (_misaligned_base, True),
    (_odd_sequence_stride, True),
    (_head_broadcast, True),
], ids=["model-q", "model-kv", "contiguous", "odd-unit-strides", "base-off-16B",
        "odd-seq-stride", "stride-0"])
def test_bf16_inputs_off_tma_alignment_are_copied(make, copied):
    """bfloat16 inputs that TMA cannot read (base off 16 bytes, a stride not
    a multiple of 16 bytes, a broadcast) are copied to contiguous tensors
    with the same values; the rest pass as they are.  float32 always passes."""
    t = make(torch.bfloat16)
    assert fa_kernel.tma_ready(t) is not copied
    got = fa_kernel.kernel_inputs(t, t, t)
    for g in got:
        assert (g is not t) is copied
        torch.testing.assert_close(g, t, rtol=0, atol=0)
        if copied:
            assert g.is_contiguous() and fa_kernel.tma_ready(g)
    t32 = make(torch.float32)
    assert all(g is t32 for g in fa_kernel.kernel_inputs(t32, t32, t32))


def test_non_cpu_tensors_go_to_the_launcher(monkeypatch):
    """A tensor off the CPU goes to the kernel launcher with the model's
    views uncopied and the default scale; the launch is counted.  (``meta``
    stands in for a CUDA tensor.)"""
    seen = {}

    def launcher(q, k, v, *, causal, scale, window):
        seen.update(q=q, k=k, v=v, causal=causal, scale=scale, window=window)
        return torch.empty_like(q)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", launcher)
    q, k, v = _model_views(1, 4, 2, 16, 64, torch.bfloat16, "meta")
    trace.reset_counts(fa_ops.LAUNCHES)
    out = fa_ops.flash_attention_gqa(q, k, v)
    assert trace.counter(fa_ops.LAUNCHES) == 1 and out.shape == q.shape
    assert seen["q"] is q and seen["k"] is k and seen["v"] is v
    assert seen["causal"] is True and seen["scale"] == 64**-0.5 and seen["window"] == 0


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_non_cpu_inputs_that_need_grad_raise(monkeypatch, needs_grad):
    """The kernel has no backward: off the CPU, an input that requires grad
    raises before the launcher is reached (``meta`` stands in for CUDA); under
    ``no_grad`` the same inputs launch, and on the CPU the plain version
    keeps its autograd."""
    launched = []
    monkeypatch.setattr(fa_ops, "flash_attention_fwd",
                        lambda q, k, v, **kw: launched.append(1) or torch.empty_like(q))
    q, k, v = _model_views(1, 4, 2, 16, 64, torch.bfloat16, "meta")
    inputs = {"q": q, "k": k, "v": v}
    inputs[needs_grad] = inputs[needs_grad].detach().requires_grad_()
    trace.reset_counts(fa_ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention_gqa(**inputs)
    assert launched == [] and trace.counter(fa_ops.LAUNCHES) == 0
    with torch.no_grad():
        fa_ops.flash_attention_gqa(**inputs)
    assert launched == [1] and trace.counter(fa_ops.LAUNCHES) == 1

    cpu = {n: torch.randn(1, 4 if n == "q" else 2, 16, 64) for n in "qkv"}
    cpu[needs_grad].requires_grad_()
    out = fa_ops.flash_attention_gqa(**cpu)
    (grad,) = torch.autograd.grad(out.sum(), cpu[needs_grad])
    assert grad.shape == cpu[needs_grad].shape and bool(grad.abs().sum() > 0)


@pytest.mark.parametrize("kernel_name", ["flash_attention", "ssd_scan", "fingerprint"])
def test_library_name_hashes_source_and_shared_flags(kernel_name, tmp_path):
    """Every kernel's library is named by a hash of its source and the one
    shared ``NVCC_FLAGS``, and a library of that name is reused without
    ``nvcc``: the flash kernel needs no flags of its own."""
    import hashlib
    import importlib

    from repro_torch.kernels import _nvcc

    mod = importlib.import_module(f"repro_torch.kernels.{kernel_name}.kernel")
    digest = hashlib.sha256(mod.SOURCE.read_bytes() + " ".join(_nvcc.NVCC_FLAGS).encode())
    want = tmp_path / f"lib{kernel_name}_{digest.hexdigest()[:16]}.so"
    want.write_bytes(b"")
    assert _nvcc.compile_library(mod.SOURCE, tmp_path, kernel_name) == (want, "")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dname", list(CONTRACT_DTYPES))
@pytest.mark.parametrize("hd", CONTRACT_HDS)
def test_wrapper_on_cpu_matches_jax_kernel_at_every_head_dim_and_dtype(hd, dname, causal):
    """The head dims and dtypes the CUDA wrapper now takes, against the JAX
    kernel (interpret mode), which takes them all."""
    shape = (1, 4, 2, 40, 40, hd, causal)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, seed=hd), dname)
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.PADS)
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=causal)
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    assert out.shape == tuple(ref.shape) and out.dtype == CONTRACT_DTYPES[dname][1]
    _close(out, ref, CONTRACT_TOL[dname])
    # the plain version pads nothing
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(fa_ops.PADS) == 0


@pytest.mark.parametrize("hd, width", [(8, 16), (40, 64), (72, 80), (112, 128), (160, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_padded_head_dim_keeps_the_result(hd, width, causal):
    """What the wrapper does for a head dim without an instance: zeros past
    hd add nothing to q . k, the padded output columns are zero and sliced
    off, and the scale stays the true hd**-0.5."""
    (q, k, v) = (torch.from_numpy(a) for a in _inputs((1, 4, 2, 33, 33, hd, causal), seed=5))
    pad = lambda t: torch.nn.functional.pad(t, (0, width - hd))  # noqa: E731
    padded = attention_ref(pad(q), pad(k), pad(v), causal=causal, scale=hd**-0.5)
    assert bool((padded[..., hd:] == 0).all())
    torch.testing.assert_close(padded[..., :hd], attention_ref(q, k, v, causal=causal),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hd, dtype, want", [
    (16, torch.bfloat16, ("fa_fwd_tc<bf16>", 16, False)),
    (64, torch.float16, ("fa_fwd_tc<f16>", 64, False)),
    (80, torch.bfloat16, ("fa_fwd_tc<bf16>", 80, False)),
    (96, torch.float16, ("fa_fwd_tc<f16>", 96, False)),
    (128, torch.float32, ("fa_fwd_f32", 128, False)),
    (256, torch.bfloat16, ("fa_fwd_tc<bf16>", 256, False)),
    (1, torch.float32, ("fa_fwd_f32", 16, True)),
    (72, torch.float16, ("fa_fwd_tc<f16>", 80, True)),
    (88, torch.bfloat16, ("fa_fwd_tc<bf16>", 96, True)),
    (112, torch.float32, ("fa_fwd_f32", 128, True)),
    (129, torch.bfloat16, ("fa_fwd_tc<bf16>", 256, True)),
], ids=str)
def test_kernel_route_names_the_instance_and_the_pad(hd, dtype, want):
    """The dtype picks the kernel, the least instance of at least hd its
    head dim; every head dim up to 256 has one."""
    assert fa_kernel.kernel_route(hd, dtype) == want
    assert want[1] in fa_kernel.HEAD_DIMS


@pytest.mark.parametrize("hd, dtype, err", [(-1, torch.bfloat16, ValueError),
                                            (300, torch.float64, TypeError),
                                            (0, torch.float16, ValueError),
                                            (64, torch.float64, TypeError)], ids=str)
def test_kernel_route_refuses_past_the_contract(hd, dtype, err):
    """No head dim below 1 and no dtype but float32, bfloat16 and float16
    has a kernel, over 256 (the wide kernel) as below."""
    with pytest.raises(err, match="head dim|dtype"):
        fa_kernel.kernel_route(hd, dtype)


@pytest.mark.parametrize("hd, dtype, want", [
    (257, torch.bfloat16, ("fa_fwd_wide<bf16>", 257, False)),
    (300, torch.float32, ("fa_fwd_wide<f32>", 300, False)),
    (320, torch.float16, ("fa_fwd_wide<f16>", 320, False)),
    (384, torch.bfloat16, ("fa_fwd_wide<bf16>", 384, False)),
    (512, torch.float32, ("fa_fwd_wide<f32>", 512, False)),
    (1000, torch.float16, ("fa_fwd_wide<f16>", 1000, False)),
], ids=str)
def test_kernel_route_sends_head_dims_over_256_to_the_wide_kernel(hd, dtype, want):
    """Over 256 (wgmma's widest N) every dtype takes the wide kernel at its
    own head dim, unpadded; at 256 and below nothing changes route."""
    assert fa_kernel.kernel_route(hd, dtype) == want
    assert fa_kernel.kernel_route(256, dtype)[0] == fa_kernel._KERNELS[dtype]


@pytest.mark.parametrize("hd", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_check_contract_takes_every_instance(hd, dtype):
    fa_kernel.check_contract([(2, 8, 100, hd), (2, 2, 100, hd), (2, 2, 100, hd)],
                             [dtype] * 3, (1, 1, 1))


@pytest.mark.parametrize("hd", [257, 300, 320, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_check_contract_takes_wide_head_dims(hd, dtype):
    """Any head dim over 256 goes to the wide kernel as it is."""
    fa_kernel.check_contract([(2, 8, 100, hd), (2, 2, 100, hd), (2, 2, 100, hd)],
                             [dtype] * 3, (1, 1, 1))


@pytest.mark.parametrize("case, err", [
    ("head dim without an instance", ValueError),
    ("mixed dtypes", TypeError),
    ("float64", TypeError),
    ("strided head dim", ValueError),
    ("k and v differ", ValueError),
    ("3-d q", ValueError),
    ("wide head dim in float64", TypeError),
    ("wide head dim, mixed dtypes", TypeError),
    ("wide head dim, strided", ValueError),
    ("wide head dim, k narrower than q", ValueError),
    ("head dim 0", ValueError),
])
def test_check_contract_refuses(case, err):
    """The launcher's contract, read without a card: a padded head dim must
    be padded before the launcher, and the rest as before, at the wide
    kernel's head dims too."""
    q, k, v = (2, 8, 100, 64), (2, 2, 100, 64), (2, 2, 100, 64)
    wide = (2, 8, 100, 320), (2, 2, 100, 320), (2, 2, 100, 320)
    dts, last = [torch.bfloat16] * 3, [1, 1, 1]
    if case == "head dim without an instance":
        q, k, v = (2, 8, 100, 72), (2, 2, 100, 72), (2, 2, 100, 72)
    elif case == "mixed dtypes":
        dts[2] = torch.float16
    elif case == "float64":
        dts = [torch.float64] * 3
    elif case == "strided head dim":
        last[1] = 2
    elif case == "k and v differ":
        v = (2, 2, 99, 64)
    elif case == "3-d q":
        q = (2, 8, 64)
    elif case == "wide head dim in float64":
        (q, k, v), dts = wide, [torch.float64] * 3
    elif case == "wide head dim, mixed dtypes":
        (q, k, v), dts = wide, [torch.float32, torch.float32, torch.bfloat16]
    elif case == "wide head dim, strided":
        (q, k, v), last = wide, [2, 1, 1]
    elif case == "wide head dim, k narrower than q":
        (q, _, _), k, v = wide, (2, 2, 100, 300), (2, 2, 100, 300)
    else:
        q, k, v = (2, 8, 100, 0), (2, 2, 100, 0), (2, 2, 100, 0)
    with pytest.raises(err):
        fa_kernel.check_contract([q, k, v], dts, last)


@pytest.mark.parametrize("hd, dtype", [(80, torch.bfloat16), (96, torch.float16),
                                       (256, torch.bfloat16), (128, torch.float16)], ids=str)
def test_new_instances_take_the_model_views_uncopied(monkeypatch, hd, dtype):
    """At a head dim with an instance the model's permuted q and transposed
    k and v reach the launcher as they are (TMA-ready at hd 80, 96 and 256
    too), with the true scale; nothing is padded."""
    seen = {}

    def launcher(q, k, v, *, causal, scale, window):
        seen.update(q=q, k=k, v=v, scale=scale, window=window)
        return torch.empty_like(q)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", launcher)
    q, k, v = _model_views(1, 4, 2, 16, hd, dtype, "meta")
    assert all(fa_kernel.tma_ready(t) for t in (q, k, v))
    assert fa_kernel.kernel_inputs(q, k, v) == (q, k, v)
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.PADS)
    out = fa_ops.flash_attention_gqa(q, k, v)
    assert (trace.counter(fa_ops.LAUNCHES), trace.counter(fa_ops.PADS)) == (1, 0)
    assert out.shape == q.shape
    assert seen["q"] is q and seen["k"] is k and seen["v"] is v and seen["scale"] == hd**-0.5
    assert seen["window"] == 0
    out_args = fa_kernel.kernel_args(q, k, v, torch.empty_like(q))
    assert out_args[0] == fa_kernel._DTYPES[dtype] and out_args[6] == hd


@pytest.mark.parametrize("hd, width", [(72, 80), (112, 128), (200, 256)])
def test_padded_head_dims_reach_the_launcher_padded(monkeypatch, hd, width):
    """A head dim without an instance reaches the launcher zero-padded to
    the next one, dense (so TMA-ready), with the scale of the true head dim;
    the output comes back at hd and the pad is counted."""
    seen = {}

    def launcher(q, k, v, *, causal, scale, window):
        seen.update(q=q, k=k, v=v, scale=scale, window=window)
        return torch.empty_like(q)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", launcher)
    q, k, v = _model_views(1, 4, 2, 16, hd, torch.bfloat16, "meta")
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.PADS)
    out = fa_ops.flash_attention_gqa(q, k, v)
    assert (trace.counter(fa_ops.LAUNCHES), trace.counter(fa_ops.PADS)) == (1, 1)
    assert out.shape == q.shape and seen["scale"] == hd**-0.5 and seen["window"] == 0
    for name, t in (("q", q), ("k", k), ("v", v)):
        got = seen[name]
        assert got.shape == (*t.shape[:3], width) and got.is_contiguous()
        assert fa_kernel.tma_ready(got)


@pytest.mark.parametrize("hd, dtype", [(288, torch.bfloat16), (320, torch.float32),
                                       (512, torch.float16)], ids=str)
def test_head_dims_over_256_raise_before_the_launcher(monkeypatch, hd, dtype):
    """Over 256 the wrapper no longer raises: the model's views reach the
    launcher once, unpadded and uncopied (the wide kernel loads element by
    element, so TMA's alignment does not matter), with the true scale."""
    seen = []

    def launcher(q, k, v, *, causal, scale, window):
        seen.append((q, k, v, scale))
        return torch.empty_like(q)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", launcher)
    q, k, v = _model_views(1, 4, 2, 16, hd, dtype, "meta")
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.PADS)
    out = fa_ops.flash_attention_gqa(q, k, v)
    assert (trace.counter(fa_ops.LAUNCHES), trace.counter(fa_ops.PADS)) == (1, 0) and len(seen) == 1
    got_q, got_k, got_v, scale = seen[0]
    assert got_q is q and got_k is k and got_v is v and scale == hd**-0.5
    assert out.shape == q.shape
    cpu = [torch.zeros(t.shape) for t in (q, k, v)]
    assert fa_ops.flash_attention_gqa(*cpu).shape == q.shape  # the plain version takes any hd


def test_wide_inputs_off_tma_alignment_pass_uncopied():
    """The wide kernel reads element by element: a bf16 q 2 bytes off a
    16-byte boundary is not copied (below hd 256 it would be)."""
    hd = 320
    base = torch.empty(4 * 16 * hd + 1, dtype=torch.bfloat16, device="meta")
    q = base[1:].view(1, 4, 16, hd)
    k = v = torch.empty(1, 2, 16, hd, dtype=torch.bfloat16, device="meta")
    assert not fa_kernel.tma_ready(q)
    got = fa_kernel.kernel_inputs(q, k, v)
    assert got[0] is q and got[1] is k and got[2] is v
    args = fa_kernel.kernel_args(q, k, v, torch.empty_like(q))
    assert args[:7] == (1, 1, 4, 2, 16, 16, hd)


def test_kernel_source_has_the_wide_kernel():
    """fa_fwd_wide is a hand-written kernel for every dtype, reached for any
    head dim over the widest instance, with no library call inside."""
    src = fa_kernel.SOURCE.read_text()
    assert "fa_fwd_wide(const E* __restrict__ q" in src
    assert "constexpr int kWidestInstance = 256;" in src
    assert "if (hd > kWidestInstance)" in src
    for t in ("float", "__nv_bfloat16", "__half"):
        assert f"wide::launch<{t}>(REPRO_FA_WIDE_ARGS)" in src
    for lib in ("cublas", "cudnn", "cutlass", "torch"):
        assert lib not in src.lower()


WIDE_HDS = [300, 320, 512]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", WIDE_HDS)
def test_wrapper_on_cpu_matches_jax_kernel_over_256(hd, causal):
    """The head dims over 256 that the CUDA wrapper now launches (the wide
    kernel), against the JAX kernel in interpret mode, in float32."""
    shape = (1, 4, 2, 40, 40, hd, causal)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, seed=hd), "float32")
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.PADS)
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=causal)
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    assert out.shape == tuple(ref.shape) and out.dtype == torch.float32
    _close(out, ref, TOL["float32"])
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(fa_ops.PADS) == 0


# (B, H, KV, S, hd, window): the prompt below, at and four times the window,
# S off the kernel's 128-key tile, groups of 1 and 5, hd 64 and 128, and
# windows at and below a tile, where the kernel skips whole tiles and a row's
# first tile holds none of its keys
WINDOW_CASES = [
    (1, 4, 4, 40, 64, 64),
    (1, 5, 1, 64, 64, 64),
    (2, 4, 4, 256, 64, 64),
    (1, 10, 2, 300, 128, 100),
    (1, 4, 4, 200, 128, 128),
    (1, 5, 1, 260, 128, 17),
    (1, 4, 2, 300, 64, 1),
]


@pytest.mark.parametrize("shape", WINDOW_CASES, ids=str)
def test_wrapper_with_a_window_matches_jax_chunked_attention(shape):
    """The wrapper's window on its CPU route against the JAX package's
    ``chunked_attention`` (the windowed prefill's path there) at the same
    window, in float32 at the JAX kernel sweep's tolerance; at a window of
    at least S the result is the causal one exactly."""
    B, H, KV, S, hd, window = shape
    G = H // KV
    q, k, v = _inputs((B, H, KV, S, S, hd, True), seed=S + window)
    ref = jax_chunked(jnp.asarray(q.reshape(B, KV, G, S, hd).transpose(0, 3, 1, 2, 4)),
                      jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3)),
                      causal=True, window=window, chunk=64)
    ref = np.asarray(ref).transpose(0, 2, 3, 1, 4).reshape(B, H, S, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.WINDOWS)
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=True, window=window)
    assert out.shape == (B, H, S, hd) and out.dtype == torch.float32
    _close(out, ref, TOL["float32"])
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(fa_ops.WINDOWS) == 0
    if window >= S:
        assert torch.equal(out, fa_ops.flash_attention_gqa(tq, tk, tv, causal=True))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("causal, window", [(False, 16), (True, -1)])
def test_a_window_needs_a_causal_call(monkeypatch, device, causal, window):
    """A window on a non-causal call, or a negative one, raises before the
    plain version or the launcher (no caller needs either)."""
    launched = []
    monkeypatch.setattr(fa_ops, "flash_attention_fwd",
                        lambda q, k, v, **kw: launched.append(1) or torch.empty_like(q))
    q, k, v = _model_views(1, 4, 2, 16, 64, torch.bfloat16, device)
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention_gqa(q, k, v, causal=causal, window=window)
    assert launched == []


def test_a_window_reaches_the_launcher_and_is_counted(monkeypatch):
    """Off the CPU (``meta`` for CUDA) the window reaches the launcher with
    the model's views, and the launch counts in ``LAUNCHES`` and
    ``WINDOWS``; a call without one counts in ``LAUNCHES`` alone."""
    seen = []
    monkeypatch.setattr(fa_ops, "flash_attention_fwd",
                        lambda q, k, v, *, causal, scale, window:
                        seen.append((q, causal, window)) or torch.empty_like(q))
    q, k, v = _model_views(2, 25, 5, 64, 64, torch.bfloat16, "meta")
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.WINDOWS)
    fa_ops.flash_attention_gqa(q, k, v, causal=True, window=32)
    assert (trace.counter(fa_ops.LAUNCHES), trace.counter(fa_ops.WINDOWS)) == (1, 1)
    fa_ops.flash_attention_gqa(q, k, v, causal=True)
    assert (trace.counter(fa_ops.LAUNCHES), trace.counter(fa_ops.WINDOWS)) == (2, 1)
    assert [(got is q, causal, window) for got, causal, window in seen] == [
        (True, True, 32), (True, True, 0)]


def test_kernel_source_has_the_band_kernel():
    """The window is a template flag of each kernel's CTA body, so the
    instances without one compile as before; the 16-bit windowed kernel
    has a name of its own, and the C entry point takes the window after
    the causal flag."""
    src = fa_kernel.SOURCE.read_text()
    assert 'extern "C" int repro_fa_fwd_window' in src
    assert "float scale, int causal, int window,\n" in src
    assert "fa_fwd_cta<HD, E, false>(qmap" in src and "fa_fwd_cta<HD, E, true>(qmap" in src
    assert "window > 0 ? fa_fwd_band<HD, E> : fa_fwd_tc<HD, E>" in src
    assert "window > 0 ? fa_fwd_f32<HD, true> : fa_fwd_f32<HD, false>" in src
    assert "window > 0 ? fa_fwd_wide<E, true> : fa_fwd_wide<E, false>" in src
