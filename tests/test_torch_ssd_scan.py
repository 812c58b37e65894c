"""The SSD scan in the PyTorch port against the JAX package, on the CPU.

The port's plain version (``ref.ssd_scan_ref``) and its wrapper on CPU
tensors (``ops.ssd_scan``) take the same numpy inputs as the JAX oracle and
the JAX Pallas kernel (interpret mode, as the JAX tests run it).  Tolerances
are the JAX kernel sweep's: 5e-4 in float32 (the chunked form and the
sequential recurrence sum in other orders), 3e-2 in bfloat16 (one bf16
rounding of outputs of a few units); float16, which the sweep does not run,
5e-3 (chip_smoke's SSD_TOL: a quarter of bfloat16's, for a mantissa of 10
bits, not 7).  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``; here the ``meta`` device stands in for a
non-CPU tensor, to show what the wrapper hands the launcher, and the pure
functions ``check_contract``, ``sub_chunks`` and ``state_tiles`` state what
the launcher takes and how it splits a chunk and a state.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.runtime import trace

torch.set_num_threads(1)

SSD_SHAPES = [
    # (B, S, H, P, N, chunk): the JAX kernel sweep's shapes
    (1, 64, 2, 16, 8, 16),
    (2, 100, 3, 32, 16, 32),      # ragged (padding path)
    (1, 256, 1, 64, 128, 128),    # mamba2-130m geometry
    (1, 33, 2, 16, 16, 64),       # S < chunk
    (2, 128, 4, 64, 16, 32),      # hymba geometry
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 5e-4, "bfloat16": 3e-2}
# the kernel's contract past the sweep: a chunk of 256 (mamba_ssm's default)
# at a ragged S = 300, a state of 256 columns, both, each in three dtypes
CONTRACT_SHAPES = [
    (1, 300, 2, 16, 16, 256),
    (1, 64, 2, 16, 256, 32),
    (1, 300, 2, 16, 256, 256),
]
# past 256: a chunk of 512 at a ragged S = 600 (the JAX wrapper keeps it
# only past S = 256), states of 320 and 384 columns (three tiles), and both
WIDE_SHAPES = [
    (1, 600, 2, 16, 16, 512),
    (1, 64, 2, 16, 320, 32),
    (1, 64, 2, 16, 384, 32),
    (1, 600, 2, 16, 384, 512),
]
CONTRACT_DTYPES = {**DTYPES, "float16": (jnp.float16, torch.float16)}
CONTRACT_TOL = {**TOL, "float16": 5e-3}


def _inputs(shape, seed=0):
    """x, a, b, c, s0 scaled as the JAX sweep scales them."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)) * 0.5
    a = -np.abs(rng.normal(size=(B, S, H))) * 0.3
    b = rng.normal(size=(B, S, H, N)) * 0.5
    c = rng.normal(size=(B, S, H, N)) * 0.5
    s0 = rng.normal(size=(B, H, P, N)) * 0.2
    return [v.astype(np.float32) for v in (x, a, b, c, s0)]


def _both(arrs, dname):
    """The first four inputs in the working dtype, s0 in float32."""
    jdt, tdt = CONTRACT_DTYPES[dname]
    j = [jnp.asarray(v).astype(jdt) for v in arrs[:4]] + [jnp.asarray(arrs[4])]
    t = [torch.from_numpy(v).to(tdt) for v in arrs[:4]] + [torch.from_numpy(arrs[4])]
    return j, t


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), rtol=tol, atol=tol
    )


def _flat(t, B, S, H):
    return t.transpose(1, 2).reshape(B * H, S, *t.shape[3:])


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_plain_version_matches_jax_oracle(shape, dname):
    B, S, H, P, N, _ = shape
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(shape), dname)
    jflat = lambda v: v.transpose(0, 2, 1, *range(3, v.ndim)).reshape(B * H, S, *v.shape[3:])  # noqa: E731
    y, sf = ssd_scan_ref(*(_flat(v, B, S, H) for v in (tx, ta, tb, tc)), ts.reshape(B * H, P, N))
    yr, sr = jax_ref(*(jflat(v) for v in (jx, ja, jb, jc)), js.reshape(B * H, P, N))
    assert y.dtype == DTYPES[dname][1] and sf.dtype == torch.float32
    _close(y, yr, TOL[dname])
    _close(sf, sr, TOL[dname])


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_wrapper_on_cpu_matches_jax_kernel(shape, dname):
    chunk = shape[-1]
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(shape, seed=1), dname)
    trace.reset_counts(ssd_ops.LAUNCHES)
    y, sf = ssd_ops.ssd_scan(tx, ta, tb, tc, ts, chunk=chunk)
    yr, sr = jax_scan(jx, ja, jb, jc, js, chunk=chunk)
    assert y.shape == tuple(yr.shape) and y.dtype == DTYPES[dname][1]
    assert sf.shape == tuple(sr.shape) and sf.dtype == torch.float32
    _close(y, yr, TOL[dname])
    _close(sf, sr, TOL[dname])
    assert trace.counter(ssd_ops.LAUNCHES) == 0  # CPU tensors never launch the kernel


def _f32(shape, seed):
    return [torch.from_numpy(v) for v in _inputs(shape, seed)]


def test_zero_initial_state_default():
    x, a, b, c, s0 = _f32((1, 32, 2, 8, 8, 16), seed=2)
    y1, s1 = ssd_ops.ssd_scan(x, a, b, c, chunk=16)
    y2, s2 = ssd_ops.ssd_scan(x, a, b, c, torch.zeros_like(s0), chunk=16)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunk_invariance_against_jax(chunk):
    """Every chunk length gives the JAX kernel's result at that length."""
    shape = (1, 64, 2, 16, 16, chunk)
    arrs = _inputs(shape, seed=3)
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(arrs, "float32")
    y, sf = ssd_ops.ssd_scan(tx, ta, tb, tc, ts, chunk=chunk)
    yr, sr = jax_scan(jx, ja, jb, jc, js, chunk=chunk)
    _close(y, yr, 5e-4)
    _close(sf, sr, 5e-4)


def test_state_hand_off_equals_a_contiguous_scan():
    """Scanning the first part, then the rest from the returned state, is
    the scan of the whole (what a prefill followed by more prompt does)."""
    x, a, b, c, s0 = _f32((2, 96, 3, 16, 16, 32), seed=4)
    y, sf = ssd_ops.ssd_scan(x, a, b, c, s0, chunk=32)
    cut = 40
    y1, s1 = ssd_ops.ssd_scan(x[:, :cut], a[:, :cut], b[:, :cut], c[:, :cut], s0, chunk=32)
    y2, s2 = ssd_ops.ssd_scan(x[:, cut:], a[:, cut:], b[:, cut:], c[:, cut:], s1, chunk=32)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, sf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [5, 37, 63])
def test_ragged_lengths_match_jax(S):
    shape = (2, S, 2, 16, 8, 16)
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(shape, seed=S), "float32")
    y, sf = ssd_ops.ssd_scan(tx, ta, tb, tc, ts, chunk=16)
    yr, sr = jax_scan(jx, ja, jb, jc, js, chunk=16)
    assert y.shape == (2, S, 2, 16)
    _close(y, yr, 5e-4)
    _close(sf, sr, 5e-4)


def test_head_broadcast_views_equal_contiguous_copies():
    """B and C as the model passes them: one group expanded over heads."""
    x, a, _, _, s0 = _f32((2, 48, 4, 16, 8, 16), seed=5)
    rng = np.random.default_rng(6)
    b1 = torch.from_numpy(rng.normal(size=(2, 48, 1, 8)).astype(np.float32))
    c1 = torch.from_numpy(rng.normal(size=(2, 48, 1, 8)).astype(np.float32))
    bv, cv = b1.expand(2, 48, 4, 8), c1.expand(2, 48, 4, 8)
    assert bv.stride(2) == 0
    y1, s1 = ssd_ops.ssd_scan(x, a, bv, cv, s0, chunk=16)
    y2, s2 = ssd_ops.ssd_scan(x, a, bv.contiguous(), cv.contiguous(), s0, chunk=16)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("S, chunk, expect", [(1024, 128, 128), (40, 128, 64), (5, 128, 8),
                                              (100, 32, 32), (1024, 256, 256), (300, 256, 256),
                                              (200, 256, 256), (100, 256, 128)])
def test_non_cpu_tensors_go_to_the_launcher(monkeypatch, S, chunk, expect):
    """A tensor off the CPU goes to the kernel launcher with the clamped
    chunk, the head-broadcast views uncopied and s0 flattened; the launch is
    counted.  (``meta`` stands in for a CUDA tensor.)"""
    seen = {}

    def launcher(x, a, b, c, s0, *, chunk):
        seen.update(x=x, a=a, b=b, c=c, s0=s0, chunk=chunk)
        return torch.empty_like(x), torch.empty_like(s0)

    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd", launcher)
    B, H, P, N = 2, 3, 16, 8
    x = torch.empty((B, S, H, P), device="meta")
    b = torch.empty((B, S, 1, N), device="meta").expand(B, S, H, N)
    trace.reset_counts(ssd_ops.LAUNCHES)
    y, sf = ssd_ops.ssd_scan(x, torch.empty((B, S, H), device="meta"), b, b, chunk=chunk)
    assert trace.counter(ssd_ops.LAUNCHES) == 1
    assert seen["chunk"] == expect
    assert seen["b"].stride() == b.stride() and seen["x"] is x
    assert seen["a"].dtype == torch.float32 and seen["s0"].shape == (B * H, P, N)
    assert y.shape == x.shape and sf.shape == (B, H, P, N)


@pytest.mark.parametrize("needs_grad", ["x", "a", "b", "c", "initial_state"])
def test_non_cpu_inputs_that_need_grad_raise(monkeypatch, needs_grad):
    """The kernel has no backward: off the CPU, an input that requires grad
    raises before the launcher is reached (``meta`` stands in for CUDA); under
    ``no_grad`` the same inputs launch, and on the CPU the plain version
    keeps its autograd."""
    launched = []

    def launcher(x, a, b, c, s0, *, chunk):
        launched.append(1)
        return torch.empty_like(x), torch.empty_like(s0)

    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd", launcher)
    B, S, H, P, N = 1, 16, 2, 16, 8
    shapes = {"x": (B, S, H, P), "a": (B, S, H), "b": (B, S, H, N), "c": (B, S, H, N),
              "initial_state": (B, H, P, N)}
    meta = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    meta[needs_grad].requires_grad_()
    trace.reset_counts(ssd_ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_scan(**meta, chunk=8)
    assert launched == [] and trace.counter(ssd_ops.LAUNCHES) == 0
    with torch.no_grad():
        ssd_ops.ssd_scan(**meta, chunk=8)
    assert launched == [1] and trace.counter(ssd_ops.LAUNCHES) == 1

    g = torch.Generator().manual_seed(0)
    cpu = {n: torch.randn(s, generator=g) * 0.3 for n, s in shapes.items()}
    cpu["a"] = -cpu["a"].abs()
    cpu[needs_grad].requires_grad_()
    y, state = ssd_ops.ssd_scan(**cpu, chunk=8)
    (grad,) = torch.autograd.grad(y.sum() + state.sum(), cpu[needs_grad])
    assert grad.shape == cpu[needs_grad].shape and bool(grad.abs().sum() > 0)


def test_kernel_launcher_refuses_non_cuda_tensors():
    x = torch.zeros(1, 8, 2, 16)
    a = torch.zeros(1, 8, 2)
    b = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_kernel.ssd_scan_fwd(x, a, b, b, torch.zeros(2, 16, 8), chunk=8)
    meta = [t.to("meta") for t in (x, a, b)]
    with pytest.raises(ValueError, match="CUDA tensor"):  # no fallback off the CPU
        ssd_ops.ssd_scan(meta[0], meta[1], meta[2], meta[2], chunk=8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(ssd_kernel, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ssd_kernel.build()
    assert not (tmp_path / "build").exists()


def test_kernel_source_targets_hopper():
    from repro_torch.kernels._nvcc import NVCC_FLAGS

    src = ssd_kernel.SOURCE.read_text()
    assert 'extern "C" int repro_ssd_scan' in src
    assert "repro/kernels/ssd_scan/kernel.py:96" in src
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    # no chunk or state limit of its own: only the grid's extents
    assert "kMaxQ" not in src and "kMaxN" not in src
    assert f"kMaxGridYZ = {ssd_kernel.MAX_GRID_YZ};" in src
    assert f"kPT = {ssd_kernel.P_TILE};" in src and f"kTileN = {ssd_kernel.TILE_N};" in src


def _model_views(B, S, H, P, N, dtype=torch.bfloat16):
    """x, a, b and c as ``apply_mamba`` hands them to the kernel: b and c
    split out of the conv output and expanded over heads (head stride 0)."""
    din = H * P
    conv = torch.empty((B, S, din + 2 * N), dtype=dtype, device="meta")
    _, b, c = torch.split(conv, [din, N, N], dim=-1)
    expand = lambda t: t[:, :, None, :].expand(B, S, H, N)  # noqa: E731
    x = torch.empty((B, S, H, P), dtype=dtype, device="meta")
    return x, torch.empty((B, S, H), device="meta"), expand(b), expand(c)


def test_serving_views_take_the_tensor_core_kernel_with_16_byte_loads():
    """mamba2-130m's prefill: every row of x and of the broadcast b and c
    starts on a 16-byte boundary, so the views load by cp.async as they lie."""
    x, a, b, c = _model_views(4, 1024, 24, 64, 128)
    assert b.stride(2) == 0 and b.data_ptr() % 16 == 0
    assert ssd_kernel.kernel_route(x, b, c) == ("tensor-core", "cp.async16")
    y = torch.empty_like(x)
    args = ssd_kernel.kernel_args(x, a, b, c, y, 128)
    assert args[:8] == (1, 1, 4, 1024, 24, 64, 128, 128)  # bf16, 16-byte loads, B S H P N Q
    assert args[8:11] == x.stride()[:3] and args[11:14] == a.stride()
    assert args[14:17] == b.stride()[:3] and args[17:20] == c.stride()[:3]
    assert args[16] == 0 and args[19] == 0  # the head broadcast is passed, not copied
    assert args[20:23] == y.stride()[:3] and len(args) == 23


@pytest.mark.parametrize("case, loads", [
    ("contiguous", "cp.async16"),
    ("x off 16 bytes", "elementwise"),
    ("b off 16 bytes", "elementwise"),
    ("N = 12", "elementwise"),
    ("P = 20", "elementwise"),
    ("sequence stride of 4 elements", "elementwise"),
])
def test_every_bf16_input_takes_the_tensor_core_kernel(case, loads):
    """The dtype picks the kernel; alignment picks only how it loads.  No
    bf16 shape goes back to the scalar kernel."""
    B, S, H, P, N = 1, 40, 2, 16, 16
    if case == "N = 12":
        N = 12
    if case == "P = 20":
        P = 20
    new = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    x, b, c = new(B, S, H, P), new(B, S, H, N), new(B, S, H, N)
    if case == "x off 16 bytes":
        x = new(B * S * H * P + 1)[1:].view(B, S, H, P)
    if case == "b off 16 bytes":
        b = new(B * S * H * N + 4)[4:].view(B, S, H, N)
    if case == "sequence stride of 4 elements":
        b = torch.as_strided(new(B * S * 4 + N), (B, S, H, N), (S * 4, 4, 0, 1))
    assert ssd_kernel.kernel_route(x, b, c) == ("tensor-core", loads)
    a = torch.empty((B, S, H), device="meta")
    assert ssd_kernel.kernel_args(x, a, b, c, torch.empty_like(x), 32)[:2] == (
        1, 1 if loads == "cp.async16" else 0)


def test_float32_takes_the_scalar_kernel():
    new = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x, b = new(1, 40, 2, 16), new(1, 40, 2, 16)
    assert ssd_kernel.kernel_route(x, b, b) == ("scalar", "elementwise")
    args = ssd_kernel.kernel_args(x, new(1, 40, 2), b, b, torch.empty_like(x), 32)
    assert args[:2] == (0, 0)


def test_kernel_source_has_the_tensor_core_kernel_for_bf16_only():
    src = ssd_kernel.SOURCE.read_text()
    assert "ssd_scan_bf16" in src and "ssd_scan_f32" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned" in src and "cp.async.cg.shared.global" in src
    assert "ssd_scan_f32<" in src and "ssd_scan_kernel<" not in src  # no bf16 scalar kernel
    assert "-INFINITY" in src  # the segment sum is -inf above the diagonal before the exp
    assert "cudaErrorMisalignedAddress" in src  # a 16-byte load it cannot make is refused


@pytest.mark.parametrize("chunk", [16, 32])
def test_rounding_study_chunked_form_matches_the_recurrence(chunk):
    """The rounding study's chunked f32 form, every rounding off, is the
    sequential recurrence; with the kernel's roundings it stays within the
    bf16 check's tolerance."""
    from repro_torch.kernels.ssd_scan import rounding

    B, S, H, P, N = 2, 64, 3, 16, 16
    x, a, b, c, s0 = (torch.from_numpy(v) for v in _inputs((B, S, H, P, N, chunk), seed=7))
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    y_ref, s_ref = ssd_scan_ref(*(_flat(v, B, S, H) for v in (x, a, b, c)),
                                s0.reshape(B * H, P, N))
    y_ref = y_ref.reshape(B, H, S, P).transpose(1, 2)
    y, state = rounding.chunked(x, a, b, c, s0, *rounding.CONFIGS["exact"], chunk=chunk)
    _close(y, y_ref.float().numpy(), 1e-2)  # y rounded to bf16 on both sides
    _close(state.reshape(B * H, P, N), s_ref.numpy(), 1e-4)
    y_k, state_k = rounding.chunked(x, a, b, c, s0,
                                    *rounding.CONFIGS["P and S hi/lo (the kernel)"], chunk=chunk)
    _close(y_k, y_ref.float().numpy(), TOL["bfloat16"])
    _close(state_k.reshape(B * H, P, N), s_ref.numpy(), TOL["bfloat16"])


def test_the_wide_state_split_keeps_the_state_exact():
    """Past 128 state columns the kernel splits X o decay into hi + lo too:
    in the study's arithmetic the state then lands within 1e-4 of the
    recurrence, where one bf16 rounding of X o decay does not."""
    from repro_torch.kernels.ssd_scan import rounding

    B, S, H, P, N = 1, 64, 2, 16, 256
    x, a, b, c, s0 = (torch.from_numpy(v) for v in _inputs((B, S, H, P, N, 32), seed=11))
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    _, s_ref = ssd_scan_ref(*(_flat(v, B, S, H) for v in (x, a, b, c)), s0.reshape(B * H, P, N))
    cfg = rounding.CONFIGS["P, S and X o decay hi/lo (the kernel past 128 columns)"]
    _, state = rounding.chunked(x, a, b, c, s0, *cfg, chunk=32)
    _close(state.reshape(B * H, P, N), s_ref.numpy(), 1e-4)
    _, state_one = rounding.chunked(x, a, b, c, s0, *rounding.CONFIGS["P and S hi/lo (the kernel)"],
                                    chunk=32)
    assert (state_one.reshape(B * H, P, N) - s_ref).abs().max() > 1e-4
    src = ssd_kernel.SOURCE.read_text()
    assert "template <bool kVec, bool kSplitXd>" in src and "const bool split_xd = N > kN;" in src


@pytest.mark.parametrize("shape", CONTRACT_SHAPES, ids=str)
@pytest.mark.parametrize("dname", list(CONTRACT_DTYPES))
def test_wrapper_on_cpu_matches_jax_kernel_past_128(shape, dname):
    """The chunk, state width and dtype the CUDA wrapper now takes, against
    the JAX kernel (interpret mode), which takes them all."""
    chunk = shape[-1]
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(shape, seed=8), dname)
    trace.reset_counts(ssd_ops.LAUNCHES, ssd_ops.TILE_SUMS)
    y, sf = ssd_ops.ssd_scan(tx, ta, tb, tc, ts, chunk=chunk)
    yr, sr = jax_scan(jx, ja, jb, jc, js, chunk=chunk)
    assert y.shape == tuple(yr.shape) and y.dtype == CONTRACT_DTYPES[dname][1]
    assert sf.dtype == torch.float32
    _close(y, yr, CONTRACT_TOL[dname])
    _close(sf, sr, CONTRACT_TOL[dname])
    assert trace.counter(ssd_ops.LAUNCHES) == trace.counter(ssd_ops.TILE_SUMS) == 0


@pytest.mark.parametrize("chunk, want", [(8, (1, 8)), (100, (1, 100)), (128, (1, 128)),
                                         (129, (2, 65)), (200, (2, 100)), (256, (2, 128)),
                                         (300, (3, 100)), (512, (4, 128)), (1000, (8, 125))])
def test_a_chunk_over_128_runs_as_sub_chunks(chunk, want):
    """The kernel stages 128 rows: a longer chunk runs as equal sub-chunks,
    256 as two of 128 (``n_sub`` and ``Qs`` of ``repro_ssd_scan``)."""
    assert ssd_kernel.sub_chunks(chunk) == want
    n, rows = want
    assert rows <= ssd_kernel.SUB_CHUNK and n * rows >= chunk > (n - 1) * rows


def test_sub_chunks_give_the_chunks_result():
    """Why the split is exact: the chunked scan's result does not depend on
    the chunk, so the JAX kernel at 256 equals itself at 128 (sub-chunks) up
    to the order of its f32 sums."""
    shape = (1, 300, 2, 16, 16, 256)
    (jx, ja, jb, jc, js), _ = _both(_inputs(shape, seed=9), "float32")
    y256, s256 = jax_scan(jx, ja, jb, jc, js, chunk=256)
    y128, s128 = jax_scan(jx, ja, jb, jc, js, chunk=ssd_kernel.sub_chunks(256)[1])
    np.testing.assert_allclose(np.asarray(y256), np.asarray(y128), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(np.asarray(s256), np.asarray(s128), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("N, tiles", [(8, 1), (128, 1), (129, 2), (200, 2), (256, 2),
                                      (320, 3), (384, 3), (1000, 8)])
def test_a_state_over_128_splits_into_tiles(N, tiles):
    assert ssd_kernel.state_tiles(N) == tiles


def _contract_shapes(B=2, S=40, H=3, P=16, N=16):
    return [(B, S, H, P), (B, S, H), (B, S, H, N), (B, S, H, N), (B * H, P, N)]


@pytest.mark.parametrize("N, chunk", [(16, 256), (256, 128), (256, 256), (200, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_check_contract_takes_chunk_and_state_up_to_256(N, chunk, dtype):
    f32 = torch.float32
    ssd_kernel.check_contract(_contract_shapes(N=N), [dtype, f32, dtype, dtype, f32],
                              (1, 1, 1, 1, 1), True, chunk)


@pytest.mark.parametrize("N, chunk", [(16, 512), (320, 128), (384, 512), (1000, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_check_contract_takes_any_chunk_and_state(N, chunk, dtype):
    f32 = torch.float32
    ssd_kernel.check_contract(_contract_shapes(N=N), [dtype, f32, dtype, dtype, f32],
                              (1, 1, 1, 1, 1), True, chunk)


@pytest.mark.parametrize("case, err", [
    ("chunk 0", ValueError),
    ("N = 0", ValueError),
    ("state tiles past the grid", ValueError),
    ("P tiles past the grid", ValueError),
    ("mixed dtypes", TypeError),
    ("float64", TypeError),
    ("a in bfloat16", TypeError),
    ("strided last dim", ValueError),
    ("s0 not dense", ValueError),
    ("c differs", ValueError),
])
def test_check_contract_refuses(case, err):
    f32, bf = torch.float32, torch.bfloat16
    shapes, dts, last, dense, chunk = _contract_shapes(), [bf, f32, bf, bf, f32], [1] * 5, True, 128
    if case == "chunk 0":
        chunk = 0
    elif case == "N = 0":
        shapes = _contract_shapes(N=0)
    elif case == "state tiles past the grid":
        shapes = _contract_shapes(N=ssd_kernel.TILE_N * ssd_kernel.MAX_GRID_YZ + 1)
    elif case == "P tiles past the grid":
        shapes = _contract_shapes(P=ssd_kernel.P_TILE * ssd_kernel.MAX_GRID_YZ + 1)
    elif case == "mixed dtypes":
        dts[3] = torch.float16
    elif case == "float64":
        dts = [torch.float64, f32, torch.float64, torch.float64, f32]
    elif case == "a in bfloat16":
        dts[1] = bf
    elif case == "strided last dim":
        last[2] = 2
    elif case == "s0 not dense":
        dense = False
    else:
        shapes[3] = (2, 40, 3, 8)
    with pytest.raises(err, match="grid" if "grid" in case else None):
        ssd_kernel.check_contract(shapes, dts, last, dense, chunk)


@pytest.mark.parametrize("N, chunk, dtype", [(256, 128, torch.bfloat16), (128, 256, torch.float16),
                                             (256, 256, torch.float32), (320, 512, torch.float32),
                                             (384, 128, torch.bfloat16), (128, 512, torch.float16)],
                         ids=str)
def test_wide_states_and_long_chunks_reach_the_launcher(monkeypatch, N, chunk, dtype):
    """A state of 256 and a chunk of 256 reach the launcher as they are (the
    kernel splits them); a state over 128 also counts the tile sum."""
    seen = {}

    def launcher(x, a, b, c, s0, *, chunk):
        seen.update(x=x, b=b, chunk=chunk)
        return torch.empty_like(x), torch.empty_like(s0)

    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd", launcher)
    x, a, b, c = _model_views(2, 1024, 3, 16, N, dtype)
    trace.reset_counts(ssd_ops.LAUNCHES, ssd_ops.TILE_SUMS)
    y, sf = ssd_ops.ssd_scan(x, a, b, c, chunk=chunk)
    assert (trace.counter(ssd_ops.LAUNCHES), trace.counter(ssd_ops.TILE_SUMS)) == (1, int(N > 128))
    assert seen["chunk"] == chunk and seen["x"] is x and seen["b"].stride() == b.stride()
    assert y.shape == x.shape and sf.shape == (2, 3, 16, N)


def test_float16_takes_the_scalar_kernel():
    """float16 has no tensor-core instance: it runs the f32 kernel, which
    widens it as it stages (dtype code 2, element-by-element loads)."""
    x, a, b, c = _model_views(1, 40, 2, 16, 16, torch.float16)
    assert ssd_kernel.kernel_route(x, b, c) == ("scalar", "elementwise")
    assert ssd_kernel.kernel_args(x, a, b, c, torch.empty_like(x), 256)[:8] == (
        2, 0, 1, 40, 2, 16, 16, 256)


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=str)
def test_wrapper_on_cpu_matches_jax_kernel_past_256(shape):
    """The chunk and state widths over 256 that the CUDA wrapper now takes,
    against the JAX kernel (interpret mode), in float32."""
    chunk = shape[-1]
    (jx, ja, jb, jc, js), (tx, ta, tb, tc, ts) = _both(_inputs(shape, seed=10), "float32")
    trace.reset_counts(ssd_ops.LAUNCHES, ssd_ops.TILE_SUMS)
    y, sf = ssd_ops.ssd_scan(tx, ta, tb, tc, ts, chunk=chunk)
    yr, sr = jax_scan(jx, ja, jb, jc, js, chunk=chunk)
    assert y.shape == tuple(yr.shape) and sf.shape == tuple(sr.shape)
    _close(y, yr, TOL["float32"])
    _close(sf, sr, TOL["float32"])
    assert trace.counter(ssd_ops.LAUNCHES) == trace.counter(ssd_ops.TILE_SUMS) == 0
