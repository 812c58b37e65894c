"""The port's int8 compression against the JAX package's, and its own tests.

``tests/test_compression.py``'s nine tests run on the port's functions (the
Store round trip through the port's Store, the hypothesis property
included).  Then the parity cases feed both packages the same seeded numpy
inputs: random blocks over many scales, exact ties (``(k + 0.5) * scale``,
which round half to even), zeros, constant blocks, lengths that are not a
multiple of the block, and bfloat16 leaves in the codec.  ``q``, the scales,
the dequantized values and the error-feedback residuals must be equal bit
for bit; so must the codec's decode after its payload went through a
round trip (``payload_nbytes`` equal too).
"""

from __future__ import annotations

import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dep (pip install -e .[test])
    from _hypothesis_stub import given, settings, st

import chip_smoke
from repro.distributed import compression as J
from repro_torch.api import ConnectorSpec, StoreConfig
from repro_torch.core.store import unregister_store
from repro_torch.distributed.compression import (
    CompressedDeltaCodec,
    compress_with_feedback,
    dequantize_int8,
    dequantize_tree,
    init_error_feedback,
    payload_nbytes,
    quantize_int8,
    quantize_tree,
)

torch.set_num_threads(1)

rng = np.random.default_rng(0)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# -- tests/test_compression.py on the port ---------------------------------------------


def test_int8_roundtrip_error_bound():
    x = _t(rng.normal(size=(1000,)).astype(np.float32))
    q, s = quantize_int8(x, block=256)
    back = dequantize_int8(q, s, x.shape)
    # error bounded by half a quantization step per block
    step = np.repeat(s.numpy(), 256)[:1000]
    assert np.all(np.abs((back - x).numpy()) <= step * 0.5 + 1e-7)


def test_quantize_zero_and_constant():
    z = torch.zeros(100)
    q, s = quantize_int8(z)
    np.testing.assert_array_equal(dequantize_int8(q, s, z.shape).numpy(), 0)
    c = torch.full((100,), 3.25)
    q, s = quantize_int8(c)
    np.testing.assert_allclose(dequantize_int8(q, s, c.shape).numpy(), 3.25, rtol=1e-2)


def test_tree_roundtrip():
    tree = {"a": _t(rng.normal(size=(64, 32)).astype(np.float32)),
            "b": [_t(rng.normal(size=(7,)).astype(np.float32))]}
    back = dequantize_tree(quantize_tree(tree))
    for o, r in ((tree["a"], back["a"]), (tree["b"][0], back["b"][0])):
        assert r.shape == o.shape
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=2e-2)


def test_error_feedback_unbiased_over_steps():
    """Mean of dequantized grads converges to the true mean (EF property)."""
    true_grad = _t(rng.normal(size=(512,)).astype(np.float32)) * 1e-3
    residual = init_error_feedback({"g": true_grad})
    acc = np.zeros(512)
    steps = 50
    for _ in range(steps):
        qt, residual = compress_with_feedback({"g": true_grad}, residual)
        acc += dequantize_int8(*qt["g"][:2], true_grad.shape).numpy()
    mean_err = np.abs(acc / steps - true_grad.numpy()).max()
    naive_q, naive_s = quantize_int8(true_grad)
    naive_err = np.abs(dequantize_int8(naive_q, naive_s, true_grad.shape).numpy()
                       - true_grad.numpy()).max()
    assert mean_err < naive_err / 3  # feedback beats memoryless quantization


def test_compression_ratio():
    tree = {"w": _t(rng.normal(size=(256, 256)).astype(np.float32))}
    qt = quantize_tree(tree)
    assert payload_nbytes(qt) < 256 * 256 * 4 / 3  # ~4x minus scale overhead


def test_delta_codec_roundtrip_and_size():
    base = {"w": _t(rng.normal(size=(128, 128)).astype(np.float32))}
    codec = CompressedDeltaCodec(base)
    stepped = {"w": base["w"] + _t(rng.normal(size=(128, 128)).astype(np.float32)) * 1e-3}
    payload = codec.encode(stepped)
    out = codec.decode(payload)
    # half-step = max|delta|/254 per block ~ 2e-5 here
    np.testing.assert_allclose(out["w"].numpy(), stepped["w"].numpy(), atol=5e-5)
    assert payload_nbytes(payload) < 128 * 128 * 4 / 3


def test_delta_codec_rebase():
    codec = CompressedDeltaCodec({"w": torch.zeros(64)})
    s1 = {"w": torch.full((64,), 10.0)}
    codec.rebase(s1)
    out = codec.decode(codec.encode({"w": s1["w"] + 0.001}))
    np.testing.assert_allclose(out["w"].numpy(), (s1["w"] + 0.001).numpy(), atol=1e-6)


@pytest.fixture
def store():
    """A registered in-memory store of the port on a fresh segment."""
    cfg = StoreConfig("test-store-torch", ConnectorSpec("memory",
                                                        segment=f"t-{uuid.uuid4().hex[:8]}"))
    s = cfg.build(register=True)
    yield s
    s.connector.clear()
    s.close()
    unregister_store("test-store-torch")


def test_delta_codec_through_store(store):
    """Composition with the paper's plane: deltas proxied through the Store."""
    from repro_torch.core import is_proxy

    base = {"w": _t(rng.normal(size=(256, 256)).astype(np.float32))}
    codec = CompressedDeltaCodec(base)
    new_state = {"w": base["w"] * 1.001}
    p = store.proxy(codec.encode(new_state))
    assert is_proxy(p)
    out = codec.decode({"w": tuple(p["w"])})
    np.testing.assert_allclose(out["w"].numpy(), new_state["w"].numpy(), rtol=1e-3, atol=1e-3)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 2048), seed=st.integers(0, 2**31 - 1),
       scale=st.floats(1e-6, 1e3))
def test_property_quantize_bounded(n, seed, scale):
    r = np.random.default_rng(seed)
    x = _t((r.normal(size=(n,)) * scale).astype(np.float32))
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, x.shape)
    blk = np.repeat(s.numpy(), 256)[:n]
    assert np.all(np.abs((back - x).numpy()) <= blk * 0.51 + 1e-9)


# -- bit-for-bit parity with the JAX package ---------------------------------------------


def _inputs(kind: str, n: int) -> np.ndarray:
    r = np.random.default_rng([sum(map(ord, kind)), n])
    if kind == "random":
        return (r.normal(size=n) * 10.0 ** r.uniform(-6, 3)).astype(np.float32)
    if kind == "ties":
        scale = np.float32(0.0123)
        x = ((r.integers(-126, 126, n) + 0.5) * scale).astype(np.float32)
        x[::256] = 127 * scale  # every block's max: its scale is `scale` again
        return x
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "constant":
        return np.full(n, -2.75, np.float32)
    if kind == "mixed":  # a zero block, a constant block, a random one
        x = np.zeros(n, np.float32)
        x[256:512] = 5.0
        x[512:] = r.normal(size=n - 512).astype(np.float32)
        return x
    raise ValueError(kind)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


CASES = [(kind, n) for kind in ("random", "ties", "zeros", "constant")
         for n in (1, 255, 256, 1000, 4097)] + [("mixed", 1000), ("mixed", 4097)]


@pytest.mark.parametrize("kind, n", CASES)
def test_quantize_and_dequantize_equal_jax_bit_for_bit(kind, n):
    x = _inputs(kind, n).reshape(-1)
    jq, js = J.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    shape = (n,)
    np.testing.assert_array_equal(_bits(dequantize_int8(tq, ts, shape).numpy()),
                                  _bits(J.dequantize_int8(jq, js, shape)))


@pytest.mark.parametrize("kind", ["random", "ties", "mixed"])
def test_error_feedback_equals_jax_bit_for_bit(kind):
    """Ten steps of compress_with_feedback on a 2-d leaf and a short one:
    every step's q, scales and residual."""
    grads = {"w": _inputs(kind, 1000).reshape(40, 25), "b": _inputs("random", 7)}
    jres = J.init_error_feedback(jax.tree.map(jnp.asarray, grads))
    tres = init_error_feedback({k: _t(v) for k, v in grads.items()})
    for _ in range(10):
        jq, jres = J.compress_with_feedback(jax.tree.map(jnp.asarray, grads), jres)
        tq, tres = compress_with_feedback({k: _t(v) for k, v in grads.items()}, tres)
        for k in grads:
            np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
            np.testing.assert_array_equal(_bits(tq[k][1].numpy()), _bits(jq[k][1]))
            assert tq[k][2] == tuple(jq[k][2])
            np.testing.assert_array_equal(_bits(tres[k].numpy()), _bits(jres[k]))


def test_tree_forms_equal_jax_bit_for_bit():
    tree = {"a": _inputs("random", 2048).reshape(32, 64), "b": {"c": _inputs("ties", 300)}}
    jback = J.dequantize_tree(J.quantize_tree(jax.tree.map(jnp.asarray, tree)))
    tback = dequantize_tree(quantize_tree({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}))
    np.testing.assert_array_equal(_bits(tback["a"].numpy()), _bits(jback["a"]))
    np.testing.assert_array_equal(_bits(tback["b"]["c"].numpy()), _bits(jback["b"]["c"]))


def test_delta_codec_equals_jax_after_a_round_trip(store):
    """f32 and bf16 leaves: the payloads are equal (q, scales, shape, dtype
    token) and so is ``payload_nbytes``; each side decodes the other's
    payload after a trip through the port's Store, and the decoded leaves
    are equal bit for bit, in the leaf's own dtype."""
    r = np.random.default_rng(11)
    base = {"w": r.normal(size=(64, 48)).astype(np.float32),
            "h": r.normal(size=(300,)).astype(np.float32)}
    state = {"w": base["w"] + r.normal(size=(64, 48)).astype(np.float32) * 1e-2,
             "h": (base["h"] + r.normal(size=(300,)).astype(np.float32) * 1e-2)
             .astype(ml_dtypes.bfloat16)}
    jcodec = J.CompressedDeltaCodec(base)
    tcodec = CompressedDeltaCodec({k: _t(v) for k, v in base.items()})
    jpay = jcodec.encode({k: jnp.asarray(v) for k, v in state.items()})
    tpay = tcodec.encode({"w": _t(state["w"]),
                          "h": _t(state["h"].view(np.uint16)).view(torch.bfloat16)})
    assert payload_nbytes(tpay) == J.payload_nbytes(jpay)
    for k in state:
        np.testing.assert_array_equal(tpay[k][0], np.asarray(jpay[k][0]))
        np.testing.assert_array_equal(_bits(tpay[k][1]), _bits(jpay[k][1]))
        assert tuple(tpay[k][2]) == tuple(jpay[k][2]) and tpay[k][3] == jpay[k][3]
    assert tpay["h"][3] == "bfloat16"
    trip = {k: tuple(store.proxy(tpay)[k]) for k in tpay}
    tout = tcodec.decode(trip)
    jout = jcodec.decode(jpay)
    assert tout["h"].dtype == torch.bfloat16 and tout["w"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(tout["w"].numpy()), _bits(jout["w"]))
    np.testing.assert_array_equal(tout["h"].view(torch.uint16).numpy(),
                                  np.asarray(jout["h"]).view(np.uint16))


def test_a_dtensor_leaf_raises():
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        x = distribute_tensor(torch.ones(300), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor leaf"):
            quantize_int8(x)
        with pytest.raises(TypeError, match="DTensor leaf"):
            compress_with_feedback({"g": x}, {"g": torch.zeros(300)})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entry", chip_smoke.COMPRESS_GOLDEN, ids=lambda e: f"{e[0]}-{e[1]}")
def test_chip_smoke_compress_golden_digests(entry):
    """Every pinned digest of ``chip_smoke.COMPRESS_GOLDEN`` is the JAX
    package's and the port's on the CPU (the card must reproduce it)."""
    kind, n, seed, want = entry
    x = chip_smoke.compress_golden_array(kind, n, seed)
    jq, js = J.quantize_int8(jnp.asarray(x))
    assert chip_smoke.compress_digest(np.asarray(jq), np.asarray(js)) == want
    assert chip_smoke.compress_digest(*quantize_int8(_t(x))) == want
