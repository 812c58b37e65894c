"""The tensor fingerprint in the PyTorch port against the JAX package, on the CPU.

Tokens are compared for equality, bit for bit: the port's plain version
(``ref.fingerprint_ref``), its wrapper on CPU tensors (``ops.fingerprint``)
and ``ops.fingerprint_token`` take the same numpy inputs as the JAX oracle,
the JAX Pallas kernel (interpret mode, as the JAX tests run it) and the JAX
``fingerprint_token``.  The pinned tokens of ``chip_smoke.FP_GOLDEN``, which
the CUDA kernel must reproduce on the card, are regenerated here against
both.  The ``meta`` device stands in for a CUDA tensor, to show what the
wrapper hands the launcher.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.fingerprint.ops import fingerprint as jax_fingerprint
from repro.kernels.fingerprint.ops import fingerprint_token as jax_token
from repro.kernels.fingerprint.ref import fingerprint_ref as jax_ref
from repro_torch.kernels.fingerprint import kernel as fp_kernel
from repro_torch.kernels.fingerprint import ops as fp_ops
from repro_torch.kernels.fingerprint import ref as fp_ref
from repro_torch.runtime import trace

torch.set_num_threads(1)

SIZES = [1, 64, 4096, 4097, 100_000]  # the JAX kernel test's sizes
EMPTY_TOKEN = [3806639145, 362143844]  # the folded initial accumulator


def _bytes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _port_token(x, **kw) -> str:
    return fp_ops.fingerprint_token(x, device="cpu", **kw)


def _array(dtype: str, seed: int = 0) -> np.ndarray:
    """The JAX dtype test's input: normal values times 100, in ``dtype``."""
    vals = np.random.default_rng(seed).normal(size=(1000,)) * 100
    if dtype == "bfloat16":
        return vals.astype(jnp.bfloat16)
    return vals.astype(dtype)


@pytest.mark.parametrize("n", SIZES)
def test_plain_version_matches_jax_oracle_and_kernel(n):
    data = _bytes(n, seed=n)
    ours = fp_ref.fingerprint_ref(torch.from_numpy(data))
    assert ours.dtype == torch.uint32 and ours.shape == (2,)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_ref(jnp.asarray(data))))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_fingerprint(jnp.asarray(data))))


@pytest.mark.parametrize("n", SIZES)
def test_wrapper_on_cpu_matches_jax_kernel(n):
    data = _bytes(n, seed=n + 1)
    trace.reset_counts(fp_ops.LAUNCHES)
    ours = fp_ops.fingerprint(torch.from_numpy(data))
    assert ours.device.type == "cpu" and ours.dtype == torch.uint32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_fingerprint(jnp.asarray(data))))
    assert trace.counter(fp_ops.LAUNCHES) == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("blocks_per_chunk", [1, 3, 7])
def test_chunked_plain_version_matches_jax(monkeypatch, blocks_per_chunk):
    """Chunk edges of the plain version's block loop change nothing."""
    monkeypatch.setattr(fp_ref, "CHUNK_BLOCKS", blocks_per_chunk)
    data = _bytes(100_000, seed=blocks_per_chunk)
    np.testing.assert_array_equal(fp_ref.fingerprint_ref(torch.from_numpy(data)).numpy(),
                                  np.asarray(jax_ref(jnp.asarray(data))))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8", "float16", "bfloat16"])
def test_token_matches_jax_over_dtypes(dtype):
    a = _array(dtype)
    want = jax_token(a)
    assert _port_token(a) == want
    t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) if dtype == "bfloat16" \
        else torch.from_numpy(a)
    assert fp_ops.fingerprint_token(t) == want


def test_transposed_array_hashes_in_row_major_order():
    a = np.random.default_rng(1).normal(size=(48, 70)).astype(np.float32).T
    want = jax_token(a)
    assert want == jax_token(np.ascontiguousarray(a))
    assert _port_token(a) == want
    t = torch.from_numpy(a.T.copy()).T
    assert not t.is_contiguous()
    assert fp_ops.fingerprint_token(t) == want


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_byte_offset_view_matches_jax(offset):
    data = _bytes(9000 + offset, seed=offset)
    view = torch.from_numpy(data)[offset:]
    assert view.data_ptr() % 4 != 0 or view.storage_offset() % 4 != 0
    assert fp_ops.fingerprint_token(view) == jax_token(data[offset:])


def test_float16_view_at_an_odd_element_matches_jax():
    h = (np.random.default_rng(3).normal(size=(2001,)) * 10).astype(np.float16)
    view = torch.from_numpy(h)[1:]
    assert fp_ops.fingerprint_token(view) == jax_token(h[1:])


@pytest.mark.parametrize("wide, narrow", [
    (np.arange(10, dtype=np.float64), np.arange(10, dtype=np.float32)),
    (np.array([1e300, -1e300, 1e-300, 2.5]), np.array([np.inf, -np.inf, 0.0, 2.5], np.float32)),
    (np.array([2**40 + 5, -(2**33) - 7], np.int64), np.array([5, -7], np.int32)),
    (np.array([2**40 + 5, 2**63 + 9], np.uint64), np.array([5, 9], np.uint32)),
], ids=["float64", "float64-range", "int64", "uint64"])
def test_64bit_inputs_are_narrowed_as_jax_narrows_them(wide, narrow):
    """With 64-bit types off, ``jnp.asarray`` narrows before hashing, so a
    64-bit input shares the token of its 32-bit narrowing."""
    with np.errstate(over="ignore"):
        want = jax_token(wide)
    assert want == jax_token(narrow)
    assert _port_token(wide) == want
    assert fp_ops.fingerprint_token(torch.from_numpy(wide)) == want


def test_float64_arange_token_is_pinned():
    assert _port_token(np.arange(10, dtype=np.float64)) == "f3184f10f0d13f6b"


@pytest.mark.parametrize("value", [np.array([True, False]), np.arange(4, dtype=np.complex64),
                                   np.arange(4, dtype=np.complex128)],
                         ids=["bool", "complex64", "complex128"])
def test_bool_and_complex_raise_type_error_as_in_jax(value):
    with pytest.raises(TypeError):
        jax_token(value)
    with pytest.raises(TypeError):
        _port_token(value)
    with pytest.raises(TypeError):
        fp_ops.fingerprint(torch.from_numpy(value))


def test_empty_input_raises_as_in_jax():
    empty = np.zeros(0, np.uint8)
    with pytest.raises(TypeError):
        jax_token(empty)
    with pytest.raises(ValueError, match="empty"):
        _port_token(empty)
    with pytest.raises(ValueError, match="empty"):
        fp_ops.fingerprint(torch.zeros((3, 0)))


def test_empty_plain_version_gives_the_folded_seed():
    ours = fp_ref.fingerprint_ref(torch.zeros(0, dtype=torch.uint8))
    assert ours.tolist() == EMPTY_TOKEN
    assert np.asarray(jax_ref(jnp.zeros(0, jnp.uint8))).tolist() == EMPTY_TOKEN


def test_int64_products_wrap_to_the_uint32_product():
    """The plain version multiplies 32-bit values in int64: the product may
    pass 2**63 and wrap, but its low 32 bits are the uint32 product."""
    top = torch.tensor([fp_ref.MASK], dtype=torch.int64) * fp_ref.M1
    assert top.item() < 0  # wrapped past 2**63
    assert (top & fp_ref.MASK).item() == (fp_ref.MASK * fp_ref.M1) & fp_ref.MASK
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    prod = torch.from_numpy(a.astype(np.int64)) * torch.from_numpy(b.astype(np.int64))
    prod &= fp_ref.MASK
    np.testing.assert_array_equal(prod.numpy(), (a.astype(np.uint32) * b.astype(np.uint32)))
    # chained as the block loop chains them, masked only at the end
    acc = torch.from_numpy(a.astype(np.int64))
    ref = a.astype(np.uint32)
    for y in b[:64]:
        acc = acc * fp_ref.M1 ^ int(y)
        ref = (ref * np.uint32(fp_ref.M1)) ^ np.uint32(y)
    np.testing.assert_array_equal((acc & fp_ref.MASK).numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.uint8, np.float16])
def test_fingerprint_dtypes(dtype):
    rng = np.random.default_rng(5)
    a = (rng.normal(size=(1000,)) * 100).astype(dtype)
    t1 = _port_token(a)
    assert t1 == _port_token(a.copy())
    a2 = a.copy()
    a2[123] += 1
    assert _port_token(a2) != t1


def test_fingerprint_bit_flip_sensitivity():
    data = _bytes(50_000, seed=6)
    base = _port_token(data)
    for pos in [0, 25_000, 49_999]:
        d = data.copy()
        d[pos] ^= 0x80
        assert _port_token(d) != base


def test_fingerprint_dispersion():
    """Tokens over similar inputs do not collide (weak avalanche check)."""
    tokens = set()
    base = np.zeros(8192, np.uint8)
    for i in range(64):
        d = base.copy()
        d[i] = 1
        tokens.add(_port_token(d))
    assert len(tokens) == 64


@pytest.mark.parametrize("entry", chip_smoke.FP_GOLDEN, ids=lambda e: f"{e[0]}-{e[1]}")
def test_pinned_golden_tokens_match_jax_and_the_port(entry):
    kind, shape, seed, token = entry
    arr = chip_smoke.fp_golden_array(kind, shape, seed)
    x = jax.lax.bitcast_convert_type(jnp.asarray(arr), jnp.bfloat16) if kind == "bfloat16" else arr
    with np.errstate(over="ignore"):
        assert jax_token(x) == token
    t = chip_smoke.fp_golden_tensor(kind, shape, seed, "cpu")
    assert tuple(t.shape) == tuple(arr.shape)
    assert t.dtype == {"bfloat16": torch.bfloat16}.get(kind, t.dtype)
    assert fp_ops.fingerprint_token(t) == token
    assert _port_token(arr) == token


def test_golden_inputs_cover_sizes_dtypes_and_strides():
    kinds = {kind for kind, *_ in chip_smoke.FP_GOLDEN}
    assert {"float32", "float16", "bfloat16", "int32", "float32.T", "float64"} <= kinds
    sizes = {shape[0] for kind, shape, *_ in chip_smoke.FP_GOLDEN if kind == "uint8"}
    assert sizes == {1, 64, 4095, 4096, 4097, 100_000, 2**20 + 3}
    t = chip_smoke.fp_golden_tensor("float32.T", (64, 100), 11, "cpu")
    assert not t.is_contiguous()


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata


@pytest.fixture
def launcher(monkeypatch):
    seen = {}

    def fake(data):
        seen["data"] = data
        return torch.zeros(2, dtype=torch.int32, device=data.device).view(torch.uint32)

    monkeypatch.setattr(fp_ops, "fingerprint_fwd", fake)
    trace.reset_counts(fp_ops.LAUNCHES)
    return seen


def test_dense_tensor_reaches_the_launcher_as_an_unpadded_byte_view(launcher):
    """(``meta`` stands in for a CUDA tensor.)"""
    x = torch.empty((37, 129), device="meta")
    out = fp_ops.fingerprint(x)
    data = launcher["data"]
    assert trace.counter(fp_ops.LAUNCHES) == 1
    assert data.dtype == torch.uint8 and data.dim() == 1 and data.stride() == (1,)
    assert data.numel() == 37 * 129 * 4  # the byte length, no padding to 4096
    assert _same_storage(data, x)  # a view: nothing copied
    assert out.shape == (2,) and out.dtype == torch.uint32


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_misaligned_view_reaches_the_launcher_uncopied(launcher, offset):
    base = torch.empty(10_000, dtype=torch.uint8, device="meta")
    fp_ops.fingerprint(base[offset:offset + 4097])
    data = launcher["data"]
    assert data.storage_offset() == offset and data.numel() == 4097
    assert _same_storage(data, base)  # the kernel reads it where it lies


def test_float16_view_at_an_odd_element_reaches_the_launcher_uncopied(launcher):
    h = torch.empty(100, dtype=torch.float16, device="meta")
    fp_ops.fingerprint(h[1:])
    data = launcher["data"]
    assert data.storage_offset() == 2 and data.numel() == 99 * 2
    assert _same_storage(data, h)


def test_non_dense_and_64bit_tensors_reach_the_launcher_made_dense(launcher):
    x = torch.empty((16, 48), device="meta").T
    fp_ops.fingerprint(x)
    assert launcher["data"].numel() == 16 * 48 * 4 and launcher["data"].stride() == (1,)
    assert not _same_storage(launcher["data"], x)  # the row-major copy
    fp_ops.fingerprint(torch.empty(50, dtype=torch.float64, device="meta"))
    assert launcher["data"].numel() == 50 * 4  # narrowed to float32
    assert trace.counter(fp_ops.LAUNCHES) == 2


def test_kernel_launcher_refuses_non_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp_kernel.fingerprint_fwd(torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):  # no fallback off the CPU
        fp_ops.fingerprint(torch.empty(16, device="meta"))


def test_token_of_an_array_needs_cuda_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fp_ops.fingerprint_token(_bytes(10))
    assert fp_ops.fingerprint_token(_bytes(10), device="cpu") == jax_token(_bytes(10))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(fp_kernel, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fp_kernel.build()
    assert not (tmp_path / "build").exists()


def test_kernel_source_targets_hopper_and_keeps_the_constants():
    from repro_torch.kernels._nvcc import NVCC_FLAGS

    src = fp_kernel.SOURCE.read_text()
    assert 'extern "C" int repro_fingerprint' in src
    assert "repro/kernels/fingerprint/kernel.py:45" in src
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert f"kLanes = {fp_kernel.LANES}" in src and fp_kernel.LANES == fp_ref.BLOCK_U32
    for name, value in (("kSeed", fp_ref.SEED), ("kPhi", fp_ref.PHI), ("kM1", fp_ref.M1)):
        assert f"{name} = 0x{value:08X}u" in src


@pytest.mark.parametrize("offset, route", [(0, "tma"), (16, "tma"), (4096, "tma"), (1, "ring"),
                                           (2, "ring"), (3, "ring"), (4, "ring"), (8, "ring"),
                                           (12, "ring")])
def test_route_follows_the_16_byte_alignment(launcher, offset, route):
    """A view whose first byte is 16-byte aligned takes the TMA route, any
    other the register ring; either way it reaches the launcher uncopied."""
    base = torch.empty(3 * 4096, dtype=torch.uint8, device="meta")
    view = base[offset:offset + 4097]
    assert fp_kernel.route(view) == route
    fp_ops.fingerprint(view)
    data = launcher["data"]
    assert _same_storage(data, base) and data.storage_offset() == offset
    assert fp_kernel.route(data) == route


def test_tma_geometry_of_the_mlp_stack():
    """The map over qwen2.5-3b's (36, 2048, 11008) f32 MLP stack: whole
    blocks as rows of 1024 words, 4096 bytes apart, read in boxes of the
    default layout."""
    n = 36 * 2048 * 11008 * 4
    geo = fp_kernel.tma_geometry(n)
    assert geo["dims"] == (1024, n // 4096) == (1024, 792_576)
    assert geo["strides"] == (4096,)
    assert geo["box"] == (fp_kernel.TMA_LANES, min(fp_kernel.TMA_ROWS, 256))
    assert geo["boxes_a_stage"] * geo["box"][1] == fp_kernel.TMA_ROWS
    assert geo["grid"] * fp_kernel.TMA_LANES == 1024
    assert geo["stages_filled"] == -(-792_576 // fp_kernel.TMA_ROWS)
    assert geo["stage_bytes"] == 4 * fp_kernel.TMA_LANES * fp_kernel.TMA_ROWS
    assert geo["smem_bytes"] <= fp_kernel.MAX_SMEM


@pytest.mark.parametrize("n, rows, filled", [(1, 1, 0), (4095, 1, 0), (4096, 1, 1),
                                             (4096 * 256, 256, 1), (4096 * 257 + 3, 257, 2)])
def test_tma_geometry_counts_whole_blocks_only(n, rows, filled):
    """The partial last block is the kernel's masked tail, never a row of the
    map; an input of less than one block loads no box but keeps one row."""
    geo = fp_kernel.tma_geometry(n, lanes=32, rows=256, stages=2)
    assert geo["dims"] == (1024, rows) and geo["stages_filled"] == filled


@pytest.mark.parametrize("lanes, rows, per_stage", [(32, 128, 1), (32, 256, 1), (32, 512, 2),
                                                    (16, 1024, 4), (8, 2048, 8)])
def test_a_stage_of_more_than_256_blocks_is_several_boxes(lanes, rows, per_stage):
    """TMA's box has at most 256 rows: a taller stage is loaded as several
    boxes onto one barrier."""
    geo = fp_kernel.tma_geometry(1 << 30, lanes=lanes, rows=rows, stages=2)
    assert geo["box"] == (lanes, min(rows, 256)) and geo["boxes_a_stage"] == per_stage
    assert geo["stage_bytes"] == 4 * lanes * rows


@pytest.mark.parametrize("lanes, rows, stages", [(7, 256, 4), (64, 256, 4), (32, 96, 4),
                                                 (32, 320, 2), (32, 0, 4), (32, 256, 0),
                                                 (32, 1024, 2)])
def test_tma_geometry_refuses_boxes_the_kernel_cannot_take(lanes, rows, stages):
    with pytest.raises(ValueError, match="box"):
        fp_kernel.tma_geometry(1 << 20, lanes=lanes, rows=rows, stages=stages)


def test_kernel_source_has_both_routes_and_their_guards():
    src = fp_kernel.SOURCE.read_text()
    assert "fingerprint_tma" in src and "fingerprint_ring" in src
    assert "cp.async.bulk.tensor.2d" in src and "kHangCycles" in src and "__trap()" in src
    assert "kMaxBoxRows = 256" in src
    assert "cudaErrorMisalignedAddress" in src  # an unaligned input is refused on the TMA route
    for name, code in fp_kernel.ROUTES.items():
        assert f"route {code} ({'TMA' if name == 'tma' else 'register ring'})" in src


def test_chip_smoke_sweep_straddles_both_routes_and_the_ring_edges():
    assert (chip_smoke.FP_STAGE_BLOCKS, chip_smoke.FP_RING_BLOCKS) == (
        fp_kernel.TMA_ROWS, fp_kernel.TMA_ROWS * fp_kernel.TMA_STAGES)
    assert {0, 1, 2, 3, 4, 8, 12} <= set(chip_smoke.FP_OFFSETS)
    lengths = set(chip_smoke.FP_LENGTHS)
    for blocks in (chip_smoke.FP_STAGE_BLOCKS, chip_smoke.FP_RING_BLOCKS):
        assert {4096 * (blocks - 1), 4096 * blocks, 4096 * (blocks + 1),
                4096 * blocks + 1} <= lengths
