"""bfloat16 tensors on the zero-copy data path, against the JAX package.

The port sends a bfloat16 tensor as its raw 16-bit words under the dtype
token ``"bfloat16"``: the header and buffers the JAX package's
``repro.core.serialize`` writes for a bfloat16 ``jax.Array`` of the same
values, byte for byte.  On the CPU the buffer is the tensor's own memory.  A
``"bfloat16"`` leaf decodes in the port as a CPU ``torch.bfloat16`` tensor
over the frame's bytes, without ``ml_dtypes``.  A tree's structure is each
package's own (a pickled ``PyTreeDef`` in the JAX package), so trees are
compared and crossed leaf by leaf; a bare array crosses whole.
"""

from __future__ import annotations

import importlib
import sys
import warnings

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

tser = importlib.import_module("repro_torch.core.serialize")
jser = importlib.import_module("repro.core.serialize")

SMALL, LARGE = (3, 50), (64, 33)  # 300 and 4224 bytes in bfloat16: under and over 512
assert np.prod(SMALL) * 2 < tser._SMALL_LEAF_BYTES < np.prod(LARGE) * 2


def _values(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bf16(shape, seed):
    """The same bfloat16 values as a torch tensor and as a jax.Array."""
    v = _values(shape, seed)
    return torch.from_numpy(v).to(torch.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)


def _trees(kind, shape):
    """(port object, reference object, the port's bfloat16 leaves)."""
    t0, j0 = _bf16(shape, 0)
    if kind == "bare":
        return t0, j0, [t0]
    t1, j1 = _bf16(shape, 1)
    if kind == "all-bf16 tree":
        return {"a": t0, "b": [t1]}, {"a": j0, "b": [j1]}, [t0, t1]
    f = _values(shape, 2)
    i = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    port = {"f32": torch.from_numpy(f), "h": t0, "i32": torch.from_numpy(i), "n": 3}
    ref = {"f32": jnp.asarray(f), "h": j0, "i32": jnp.asarray(i), "n": 3}
    return port, ref, [t0]


def _header(so):
    return msgpack.unpackb(so.header)


def _decoded_leaves(mod, so):
    """Each leaf of ``so`` decoded by ``mod`` (``treedef`` aside)."""
    buffers = [memoryview(b).cast("B") for b in so.buffers]
    return [mod._decode_leaf(leaf, buffers) for leaf in _header(so)["leaves"]]


def _bits(x) -> np.ndarray:
    """The raw 16-bit words of a bfloat16 tensor or ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _same(a, b):
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 or str(
            getattr(a, "dtype", "")) == "bfloat16":
        np.testing.assert_array_equal(_bits(a), _bits(b))
    elif isinstance(a, (int, float)):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


KINDS = ["bare", "all-bf16 tree", "mixed tree"]


@pytest.mark.parametrize("shape", [SMALL, LARGE], ids=["small", "large"])
@pytest.mark.parametrize("kind", KINDS)
def test_frames_equal_the_jax_packages(kind, shape):
    port, ref, _ = _trees(kind, shape)
    t_so, j_so = tser.serialize(port), jser.serialize(ref)
    th, jh = _header(t_so), _header(j_so)
    assert th["kind"] == jh["kind"] == "tree"
    assert th["leaves"] == jh["leaves"] and th["sizes"] == jh["sizes"]
    assert [bytes(b) for b in t_so.buffers] == [bytes(b) for b in j_so.buffers]
    for leaf in th["leaves"]:
        if leaf.get("dt") == "bfloat16":
            assert leaf["k"] == ("nd" if shape == LARGE else "nds")
    if kind == "bare":
        assert t_so.to_bytes() == j_so.to_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_large_bf16_buffers_alias_the_tensor(kind):
    port, _, bf16 = _trees(kind, LARGE)
    so = tser.serialize(port)
    nd = [leaf for leaf in _header(so)["leaves"] if leaf.get("dt") == "bfloat16"]
    assert len(nd) == len(bf16)
    for leaf, t in zip(nd, bf16):
        buf = np.frombuffer(so.buffers[leaf["i"]], np.uint8)
        assert buf.ctypes.data == t.data_ptr() and buf.nbytes == t.numel() * 2


def test_a_strided_bf16_tensor_goes_out_dense():
    t = torch.from_numpy(_values((40, 30), 3)).to(torch.bfloat16).T
    so = tser.serialize(t)
    back = tser.deserialize(so.frames())
    assert _header(so)["leaves"][0]["sh"] == [30, 40]
    np.testing.assert_array_equal(_bits(back), _bits(t.contiguous()))


@pytest.mark.parametrize("shape", [SMALL, LARGE], ids=["small", "large"])
@pytest.mark.parametrize("kind", KINDS)
def test_frames_cross_between_the_packages(kind, shape):
    """The port's frames decode in the JAX package, and the JAX package's
    in the port, bit for bit; bfloat16 comes out as ml_dtypes there and as
    a CPU torch.bfloat16 tensor here."""
    port, ref, _ = _trees(kind, shape)
    t_so, j_so = tser.serialize(port), jser.serialize(ref)
    in_ref, in_port = _decoded_leaves(jser, t_so), _decoded_leaves(tser, j_so)
    own = _decoded_leaves(tser, t_so)
    for a, b, c in zip(in_ref, in_port, own):
        _same(a, b)
        _same(b, c)
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.bfloat16 and b.device.type == "cpu"
            assert str(a.dtype) == "bfloat16"
    if kind == "bare":
        back = tser.deserialize(j_so.to_bytes())
        assert isinstance(back, torch.Tensor) and back.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(back), _bits(jser.deserialize(t_so.to_bytes())))
        assert tuple(back.shape) == shape


@pytest.mark.parametrize("shape", [SMALL, LARGE], ids=["small", "large"])
@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_without_ml_dtypes(monkeypatch, kind, shape):
    """Decoding a bfloat16 leaf imports no ml_dtypes, reads the frame's
    bytes in place and warns about nothing."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # any import raises
    port, _, bf16 = _trees(kind, shape)
    so = tser.serialize(port)
    blob = so.to_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = tser.deserialize(blob)
    leaves = [back] if kind == "bare" else [back["a"], back["b"][0]] if kind.startswith(
        "all") else [back["h"]]
    for got, want in zip(leaves, bf16):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert got.device.type == "cpu" and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    if kind == "mixed tree":
        assert back["n"] == 3 and back["f32"].dtype == np.float32
        assert back["i32"].dtype == np.int32
    if shape == LARGE:  # the tensor lies over the received bytes: no copy
        base = np.frombuffer(blob, np.uint8).ctypes.data
        assert base <= leaves[0].data_ptr() < base + len(blob)


def test_an_empty_bf16_tensor_round_trips():
    t = torch.empty((0, 7), dtype=torch.bfloat16)
    back = tser.deserialize(tser.serialize(t).frames())
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == (0, 7)
