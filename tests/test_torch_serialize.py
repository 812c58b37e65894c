"""The port's copy of the middleware on torch tensors.

``repro_torch.core.serialize`` sends CPU tensors out of band like ndarrays
(through ``tensor.numpy()``), flattens nested dicts, lists and tuples
without JAX, and pickles dtypes numpy cannot hold.  Plain ndarrays keep the
JAX package's wire format byte for byte.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.api import ClusterSpec, Session
from repro_torch.core.proxy import Proxy, SimpleFactory, is_proxy

torch.set_num_threads(1)

tser = importlib.import_module("repro_torch.core.serialize")
jser = importlib.import_module("repro.core.serialize")


def _round_trip(obj):
    so = tser.serialize(obj)
    return so, tser.deserialize(so.frames())


def test_cpu_tensor_goes_out_of_band_without_a_copy():
    t = torch.arange(4096, dtype=torch.float32)
    so, back = _round_trip(t)
    assert len(so.buffers) == 1
    assert np.shares_memory(np.frombuffer(so.buffers[0], np.float32), t.numpy())
    assert isinstance(back, np.ndarray)
    np.testing.assert_array_equal(back, t.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int64, torch.uint8])
def test_tensor_dtypes_round_trip(dtype):
    t = (torch.arange(300) % 97).to(dtype).reshape(3, 100)
    _, back = _round_trip(t)
    np.testing.assert_array_equal(back, t.numpy())
    assert back.dtype == t.numpy().dtype


def test_bfloat16_and_grad_tensors():
    bf = torch.linspace(-2, 2, 700).to(torch.bfloat16)
    _, back = _round_trip(bf)
    assert isinstance(back, torch.Tensor) and back.dtype == torch.bfloat16
    torch.testing.assert_close(back, bf, rtol=0, atol=0)
    g = torch.ones(200, requires_grad=True)
    _, back = _round_trip(g)
    np.testing.assert_array_equal(back, np.ones(200, np.float32))


def test_non_contiguous_tensor():
    t = torch.arange(2000, dtype=torch.float32).reshape(40, 50).T
    _, back = _round_trip(t)
    np.testing.assert_array_equal(back, t.numpy())


def test_nested_containers_keep_their_structure():
    obj = {"w": torch.ones(300), "layers": [np.zeros(5), (torch.arange(3), "x", None)],
           "n": 3}
    so, back = _round_trip(obj)
    assert set(back) == {"w", "layers", "n"} and back["n"] == 3
    assert isinstance(back["layers"], list) and isinstance(back["layers"][1], tuple)
    assert back["layers"][1][1:] == ("x", None)
    np.testing.assert_array_equal(back["layers"][1][0], np.arange(3))
    np.testing.assert_array_equal(back["w"], np.ones(300, np.float32))


def test_ndarray_wire_format_equals_the_jax_packages():
    arr = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32)
    assert tser.serialize(arr).to_bytes() == jser.serialize(arr).to_bytes()
    np.testing.assert_array_equal(tser.deserialize(jser.serialize(arr).to_bytes()), arr)


def test_proxy_of_a_tensor_caches_metadata_without_resolving():
    t = torch.zeros(3, 5)
    calls = []

    class Counting(SimpleFactory):
        def __call__(self):
            calls.append(1)
            return super().__call__()

    p = Proxy(Counting(t))
    assert is_proxy(p)
    assert p.__class__ is torch.Tensor and tuple(p.shape) == (3, 5)
    assert not calls
    assert np.asarray(p).shape == (3, 5) and calls


def test_session_cluster_moves_tensors():
    with Session(cluster=ClusterSpec(n_workers=2), name="torch-ser") as s:
        fut = s.submit(lambda x: x * 2, torch.arange(1000, dtype=torch.float32))
        out = fut.result(timeout=60)
    np.testing.assert_array_equal(np.asarray(out), np.arange(1000, dtype=np.float32) * 2)
