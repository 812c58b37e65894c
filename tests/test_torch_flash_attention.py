"""Flash attention in the PyTorch port against the JAX package, on the CPU.

The port's plain version (``ref.attention_ref``) and its wrapper on CPU
tensors (``ops.flash_attention_gqa``) take the same numpy inputs as the JAX
oracle and the JAX Pallas kernel (interpret mode, as the JAX tests run it).
Tolerances are the JAX kernel sweep's: 2e-4 in float32, 2e-2 in bfloat16
(one bf16 rounding of outputs near 1).  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_gqa as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

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


def _inputs(shape, seed=0):
    B, H, KV, Sq, Skv, hd, _ = shape
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=s).astype(np.float32)
        for s in [(B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)]
    )


def _both(arrs, dname):
    jdt, tdt = DTYPES[dname]
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
    fa_ops.launch_count = 0
    out = fa_ops.flash_attention_gqa(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    assert out.shape == tuple(ref.shape) and out.dtype == DTYPES[dname][1]
    _close(out, ref, TOL[dname])
    assert fa_ops.launch_count == 0  # CPU tensors never launch the kernel


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
    assert fa_kernel.HEAD_DIMS == (16, 32, 64, 128)
