"""Framed, zero-copy serialization (the paper's "serialization overhaul").

The paper speeds up array-like scientific payloads over pickle by (a)
avoiding memory copies and (b) dispatching to per-type fast paths.  This
module implements the same design for the PyTorch world:

* ``np.ndarray`` / ``torch.Tensor`` leaves are encoded as (dtype, shape)
  header metadata plus their raw data buffer -- the buffer is a
  ``memoryview`` of the original array (a CPU tensor through
  ``tensor.numpy()``), so serialization performs **zero copies**.  A CUDA
  tensor pays one device-to-host copy.  A bfloat16 tensor, which numpy
  cannot hold, goes out as its raw 16-bit words under the token
  ``"bfloat16"``, the bytes the JAX package sends for a bfloat16 array;
  it decodes as a CPU ``torch.bfloat16`` tensor over the received bytes
  (no ``ml_dtypes`` needed), every other dtype as an ndarray.  Other
  dtypes numpy cannot hold take the pickle path.
* Nested dicts, lists and tuples are flattened into leaves plus a pickled
  structure; array leaves take the fast path and everything else falls
  back to pickle protocol 5 with out-of-band buffers.
* The wire format is a small msgpack header followed by the concatenated
  buffers.  ``SerializedObject`` keeps the frames separate so connectors can
  scatter/gather (``writev``-style) without ever building one large copy.

Format::

    MAGIC(4) | u32 header_len | header (msgpack) | buffer_0 | buffer_1 | ...

Header schema::

    {
      "kind": "tree" | "pickle" | "raw",
      "sizes": [int, ...],            # frame sizes, for zero-copy splitting
      "treedef": bytes | None,        # pickled container structure ("tree" only)
      "leaves": [leaf, ...],          # "tree" only
      "n": int,                       # pickle5 frame count ("pickle" only)
    }
    leaf := {"k": "nd",  "dt": str, "sh": [int], "i": buf_index}  # big array
          | {"k": "nds", "dt": str, "sh": [int], "b": bytes}      # small array
          | {"k": "py", "b": bytes}                       # small pickled leaf
          | {"k": "pb", "i": buf_index, "n": nbuf}        # pickle5 w/ buffers
"""

from __future__ import annotations

import bisect
import io
import pickle
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import msgpack
import numpy as np

MAGIC = b"PSX1"
# Leaves smaller than this are embedded in the header rather than given their
# own frame; framing overhead would dominate otherwise.
_SMALL_LEAF_BYTES = 512


class CopyCounter:
    """Copy accounting for the data plane: ``bytes_moved`` vs ``bytes_copied``.

    ``bytes_moved`` counts payload bytes *delivered* to a consumer through
    the data plane (a dependency fetch, a gather, a store read).
    ``bytes_copied`` counts bytes that were memcpy'd along the way --
    chunk assembly on the receiving side of a peer transfer, a
    frame join, a store read that materialized fresh ``bytes``.

    The producer's single store/segment write is a *move*, not a copy, so
    a perfectly zero-copy path (shm publish -> attach-by-ref -> deserialize
    over the mapped view) scores ``copies_per_byte() == 0.0`` and the
    chunked peer path (one assembly on the receiver) scores exactly 1.0.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.bytes_copied = 0
        self.copy_ops = 0
        self.bytes_moved = 0
        self.move_ops = 0

    def add_copied(self, n: int) -> None:
        with self._lock:
            self.bytes_copied += n
            self.copy_ops += 1

    def add_moved(self, n: int) -> None:
        with self._lock:
            self.bytes_moved += n
            self.move_ops += 1

    def copies_per_byte(self) -> float:
        with self._lock:
            if self.bytes_moved == 0:
                return 0.0
            return self.bytes_copied / self.bytes_moved

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            moved = self.bytes_moved
            out = {
                "bytes_copied": self.bytes_copied,
                "copy_ops": self.copy_ops,
                "bytes_moved": moved,
                "move_ops": self.move_ops,
            }
        out["copies_per_byte"] = (out["bytes_copied"] / moved) if moved else 0.0
        return out


#: Process-global fallback counter: records copies on paths that have no
#: caller-supplied counter (e.g. a spanning-range assembly inside
#: ``deserialize``).  Workers and caches carry their own counters.
GLOBAL_COPIES = CopyCounter()


class _Scattered:
    """A logically contiguous byte string stored as N segments.

    The one home of the cumulative-offset / bisect machinery that both
    :class:`FrameBundle` (retention) and :func:`deserialize` (decode)
    read through.  ``read`` returns a zero-copy view when the range lies
    inside one segment and assembles a copy (counted on the global
    counter) when it spans; ``read_bounded`` never assembles -- it clips
    at the containing segment's edge, which is the chunked-transfer
    serving primitive.

    Offset arithmetic is plain Python ints, so segments (and ranges into
    them) past 2 GiB are safe.
    """

    __slots__ = ("_segments", "_offsets", "nbytes")

    def __init__(self, segments: Sequence[memoryview]):
        self._segments = list(segments)
        offsets = [0]
        for s in self._segments:
            offsets.append(offsets[-1] + s.nbytes)
        self._offsets = offsets
        self.nbytes = offsets[-1]

    def _locate(self, offset: int) -> tuple[int, int]:
        i = bisect.bisect_right(self._offsets, offset) - 1
        return i, offset - self._offsets[i]

    def read_bounded(self, offset: int, size: int) -> memoryview:
        """Zero-copy view of up to ``size`` bytes at ``offset``, clipped
        at the containing segment's edge -- callers advance by the
        returned length, so chunked readers never force a join."""
        if offset >= self.nbytes or size <= 0:
            return memoryview(b"")
        i, local = self._locate(offset)
        return self._segments[i][local : local + size]

    def read(self, offset: int, size: int) -> memoryview:
        size = min(size, self.nbytes - offset)
        if size <= 0:
            return memoryview(b"")
        i, local = self._locate(offset)
        seg = self._segments[i]
        if local + size <= seg.nbytes:
            return seg[local : local + size]
        out = bytearray(size)
        view = memoryview(out)
        pos = 0
        while pos < size:
            seg = self._segments[i]
            take = min(size - pos, seg.nbytes - local)
            view[pos : pos + take] = seg[local : local + take]
            pos += take
            local = 0
            i += 1
        GLOBAL_COPIES.add_copied(size)
        return view.toreadonly()


class FrameBundle:
    """One logical blob held as a list of byte frames -- the data plane's
    zero-copy unit of retention.

    Producers retain a result's serialized frames exactly as
    :func:`serialize` emitted them (views over the original arrays), peer
    serving slices ``read_range`` views bounded at frame edges, and
    consumers hand the whole bundle to :func:`deserialize` -- nothing along
    that path joins the frames into one contiguous buffer.  ``to_bytes``
    is the explicit escape hatch (one copy, counted).

    Frames are stored as read-only 1-D byte views; compares equal to any
    buffer with the same byte content, which keeps ``bytes``-era call
    sites and tests working unchanged.
    """

    __slots__ = ("frames", "nbytes", "_sc")

    def __init__(self, frames: Iterable[bytes | bytearray | memoryview]):
        self.frames: list[memoryview] = []
        for f in frames:
            mv = f if isinstance(f, memoryview) else memoryview(f)
            if mv.ndim != 1 or mv.format != "B":
                mv = mv.cast("B")
            if mv.nbytes == 0:
                continue
            self.frames.append(mv.toreadonly())
        self._sc = _Scattered(self.frames)
        self.nbytes = self._sc.nbytes

    @classmethod
    def of(cls, payload: Any) -> "FrameBundle":
        """Wrap any payload shape (bytes-like, SerializedObject, bundle)
        without copying."""
        if isinstance(payload, FrameBundle):
            return payload
        if isinstance(payload, SerializedObject):
            return cls(payload.frames())
        return cls([payload])

    def read_range(self, offset: int, size: int) -> memoryview:
        """Zero-copy view of up to ``size`` bytes at ``offset``, bounded at
        the containing frame's edge -- callers advance by the returned
        length, so chunked readers never force a cross-frame join."""
        return self._sc.read_bounded(offset, size)

    def to_bytes(self, copies: CopyCounter | None = None) -> bytes:
        """Materialize one contiguous ``bytes`` copy (counted)."""
        (copies or GLOBAL_COPIES).add_copied(self.nbytes)
        if len(self.frames) == 1:
            return bytes(self.frames[0])
        out = bytearray(self.nbytes)
        view = memoryview(out)
        pos = 0
        for f in self.frames:
            view[pos : pos + f.nbytes] = f
            pos += f.nbytes
        return bytes(out)

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __len__(self) -> int:
        return self.nbytes

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, FrameBundle):
            if other.nbytes != self.nbytes:
                return False
            return all(
                bytes(self._sc.read(o, 1 << 20)) == bytes(other._sc.read(o, 1 << 20))
                for o in range(0, self.nbytes or 1, 1 << 20)
            )
        try:
            mv = memoryview(other).cast("B")
        except TypeError:
            return NotImplemented
        if mv.nbytes != self.nbytes:
            return False
        pos = 0
        for f in self.frames:
            if f != mv[pos : pos + f.nbytes]:
                return False
            pos += f.nbytes
        return True

    __hash__ = None  # mutable-buffer container; content-compared, unhashable

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"FrameBundle(frames={len(self.frames)}, nbytes={self.nbytes})"


@dataclass
class SerializedObject:
    """A serialized object as a list of frames (header + raw buffers).

    Frames reference the original object's memory where possible; callers
    that need a contiguous blob use :meth:`to_bytes` (one copy, total).
    """

    header: bytes
    buffers: list[memoryview] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return len(MAGIC) + 4 + len(self.header) + sum(b.nbytes for b in self.buffers)

    def frames(self) -> list[bytes | memoryview]:
        return [
            MAGIC,
            len(self.header).to_bytes(4, "little"),
            self.header,
            *self.buffers,
        ]

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        for f in self.frames():
            out.write(f)
        return out.getvalue()


def _is_torch_tensor(x: Any) -> bool:
    # Never import torch here: if it is not loaded, x cannot be a tensor.
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _is_proxy(x: Any) -> bool:
    # type() bypasses the proxy's __class__ lie; import is lazy and cheap.
    from repro_torch.core.proxy import is_proxy

    return is_proxy(x)


#: the dtype token of a bfloat16 leaf (the name ml_dtypes gives the dtype,
#: as the JAX package writes it)
_BF16 = "bfloat16"


def _as_array(x: Any) -> tuple[np.ndarray, str] | None:
    """Return ``x`` as (ndarray view, dtype token) if it is array-like, else
    None.  A bfloat16 tensor comes back as a uint16 view of its bits.

    Proxies are *never* treated as arrays here: a proxy must serialize as
    its factory (cheap reference), not resolve into its target bytes.
    """
    if _is_proxy(x):
        return None
    if isinstance(x, np.ndarray) and x.dtype != object:
        return x, _dtype_token(x.dtype)
    if _is_torch_tensor(x):
        torch = sys.modules["torch"]
        # CPU: a zero-copy view; CUDA: device -> host, one copy
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        try:
            arr = t.numpy()
        except TypeError:  # float8 and other dtypes numpy cannot hold
            return None
        return arr, _dtype_token(arr.dtype)
    return None


def _dtype_token(dt: np.dtype) -> str:
    # ml_dtypes (bfloat16, float8_*) stringify as raw-void ("<V2"); their
    # .name round-trips through np.dtype() once ml_dtypes is imported.
    return dt.name if dt.str.lstrip("<>|=").startswith("V") else dt.str


def _np_dtype(token: str) -> np.dtype:
    try:
        return np.dtype(token)
    except TypeError:
        import ml_dtypes  # noqa: F401  (registers bfloat16/float8 dtypes)

        return np.dtype(token)


def _array(buf: Any, token: str, shape: list[int]) -> Any:
    """The array a leaf's bytes hold, over those bytes.  A bfloat16 leaf is
    a CPU ``torch.bfloat16`` tensor; like the ndarrays, which are read-only,
    it must not be written to (it may alias a received frame)."""
    if token != _BF16:
        return np.frombuffer(buf, dtype=_np_dtype(token)).reshape(shape)
    import torch

    bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
    if bits.size == 0:
        return torch.empty(shape, dtype=torch.bfloat16)
    # torch takes no read-only array (it warns, then aliases it anyway):
    # hand it the same memory through an interface that does not say so
    iface = dict(bits.__array_interface__, data=(bits.ctypes.data, False))
    view = np.asarray(_Words(bits, iface))
    return torch.from_numpy(view).view(torch.bfloat16)


class _Words:
    """Keeps a read-only array alive behind a writable array interface."""

    __slots__ = ("base", "__array_interface__")

    def __init__(self, base: np.ndarray, iface: dict[str, Any]):
        self.base = base
        self.__array_interface__ = iface


def _raw_view(arr: np.ndarray) -> memoryview:
    """Zero-copy byte view, including non-buffer-protocol ml_dtypes."""
    try:
        return memoryview(arr).cast("B")
    except (ValueError, TypeError):
        return memoryview(arr.reshape(-1).view(np.uint8))


def _encode_array(arr: np.ndarray, token: str, buffers: list[memoryview]) -> dict[str, Any]:
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.nbytes < _SMALL_LEAF_BYTES:
        return {"k": "nds", "dt": token, "sh": list(arr.shape), "b": arr.tobytes()}
    buffers.append(_raw_view(arr))
    return {"k": "nd", "dt": token, "sh": list(arr.shape), "i": len(buffers) - 1}


def _encode_leaf(x: Any, buffers: list[memoryview]) -> dict[str, Any]:
    found = _as_array(x)
    if found is not None:
        return _encode_array(*found, buffers)
    # Fallback: pickle-5. Out-of-band buffers keep large picklable objects
    # copy-free as well.
    oob: list[pickle.PickleBuffer] = []
    payload = pickle.dumps(x, protocol=5, buffer_callback=oob.append)
    if not oob and len(payload) < _SMALL_LEAF_BYTES:
        return {"k": "py", "b": payload}
    start = len(buffers)
    buffers.append(memoryview(payload))
    for pb in oob:
        buffers.append(pb.raw().cast("B"))
    return {"k": "pb", "i": start, "n": 1 + len(oob)}


def _decode_leaf(leaf: dict[str, Any], buffers: Sequence[memoryview]) -> Any:
    kind = leaf["k"]
    if kind == "nds":
        return _array(leaf["b"], leaf["dt"], leaf["sh"])
    if kind == "nd":
        return _array(buffers[leaf["i"]], leaf["dt"], leaf["sh"])
    if kind == "py":
        return pickle.loads(leaf["b"])
    if kind == "pb":
        start, n = leaf["i"], leaf["n"]
        payload = buffers[start]
        oob = [buffers[start + 1 + j] for j in range(n - 1)]
        return pickle.loads(payload, buffers=oob)
    raise ValueError(f"unknown leaf kind {kind!r}")


_LEAF = "*"


def _tree_flatten(obj: Any, leaves: list) -> Any:
    """Split exact dicts, lists and tuples into ``leaves`` plus a structure."""
    t = type(obj)
    if t is dict:
        return ("d", list(obj.keys()), [_tree_flatten(v, leaves) for v in obj.values()])
    if t is list or t is tuple:
        return ("l" if t is list else "t", [_tree_flatten(x, leaves) for x in obj])
    leaves.append(obj)
    return _LEAF


def _tree_unflatten(struct: Any, leaves: Iterable) -> Any:
    it = iter(leaves)

    def build(s: Any) -> Any:
        if s == _LEAF:
            return next(it)
        if s[0] == "d":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        children = [build(c) for c in s[1]]
        return children if s[0] == "l" else tuple(children)

    return build(struct)


_SCALAR_TYPES = (int, float, bool, complex, str, bytes, bytearray, type(None))


def _scan_for_array(obj: Any) -> bool:
    """Cheap recursive probe: does a builtin-container tree hold any
    array-like leaf?  Avoids a full flatten for the overwhelmingly common
    all-Python case -- control-plane messages, task arg specs, scalar
    results.  Array leaves nested inside other container types are not
    seen here; those fall back to pickle-5, which still moves their
    buffers out-of-band.
    """
    t = type(obj)
    if t in _SCALAR_TYPES:
        return False
    if t is dict:
        return any(_scan_for_array(v) for v in obj.values())
    if t is list or t is tuple:
        return any(_scan_for_array(x) for x in obj)
    if isinstance(obj, np.ndarray):
        return True
    if _is_proxy(obj):
        return False  # a proxy serializes as its factory, never as bytes
    mod = getattr(t, "__module__", None)
    if not isinstance(mod, str):  # classes that lie about their attributes
        return True  # conservative: let the flatten decide
    return mod.startswith("torch") or mod.startswith("numpy")


def _pack(header: dict[str, Any], buffers: list[memoryview]) -> SerializedObject:
    header["sizes"] = [b.nbytes for b in buffers]
    return SerializedObject(msgpack.packb(header), buffers)


def serialize(obj: Any) -> SerializedObject:
    """Serialize ``obj`` into frames, zero-copy for array leaves."""
    buffers: list[memoryview] = []

    if _is_proxy(obj):
        payload = pickle.dumps(obj, protocol=5)  # factory only, tiny
        buffers.append(memoryview(payload))
        return _pack({"kind": "pickle", "n": 1}, buffers)

    if obj is None or type(obj) in (int, float, bool, complex, str):
        # Scalar fast path: a container probe would dominate tiny task
        # results.
        payload = pickle.dumps(obj, protocol=5)
        buffers.append(memoryview(payload))
        return _pack({"kind": "pickle", "n": 1}, buffers)

    found = _as_array(obj)
    if found is not None:
        leaf = _encode_array(*found, buffers)
        return _pack({"kind": "tree", "treedef": None, "leaves": [leaf]}, buffers)

    if isinstance(obj, (bytes, bytearray, memoryview)):
        buffers.append(memoryview(obj).cast("B"))
        return _pack({"kind": "raw"}, buffers)

    if isinstance(obj, (dict, list, tuple)) and _scan_for_array(obj):
        leaves: list = []
        treedef = _tree_flatten(obj, leaves)
        # Only take the tree path when it pays: at least one array leaf.
        # (Each leaf is probed once: a CUDA tensor's probe is its one copy.)
        arrays = [_as_array(leaf) for leaf in leaves]
        if any(found is not None for found in arrays):
            encoded = [
                _encode_array(*found, buffers) if found is not None else _encode_leaf(leaf, buffers)
                for leaf, found in zip(leaves, arrays)
            ]
            return _pack(
                {
                    "kind": "tree",
                    "treedef": pickle.dumps(treedef, protocol=5),
                    "leaves": encoded,
                },
                buffers,
            )

    # Generic object: pickle-5 with out-of-band buffers.
    oob: list[pickle.PickleBuffer] = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=oob.append)
    buffers.append(memoryview(payload))
    for pb in oob:
        buffers.append(pb.raw().cast("B"))
    return _pack({"kind": "pickle", "n": 1 + len(oob)}, buffers)


class _ScatteredSplit(Sequence):
    """Lazily slice the serialized body's buffers out of a scattered blob.

    On aligned inputs (a retained frame list) every buffer is exactly one
    segment, so decode stays zero-copy end to end.
    """

    def __init__(self, data: _Scattered, body_offset: int, sizes: list[int]):
        self._data = data
        offsets = [body_offset]
        for s in sizes:
            offsets.append(offsets[-1] + s)
        self._offsets = offsets

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> memoryview:  # type: ignore[override]
        return self._data.read(
            self._offsets[i], self._offsets[i + 1] - self._offsets[i]
        )


Frames = Sequence["bytes | bytearray | memoryview"]


def _as_segments(data: "bytes | bytearray | memoryview | FrameBundle | Frames") -> list[memoryview]:
    if isinstance(data, FrameBundle):
        return data.frames
    if isinstance(data, (bytes, bytearray, memoryview)):
        mv = memoryview(data)
        if mv.ndim != 1 or mv.format != "B":
            mv = mv.cast("B")
        return [mv]
    # An arbitrary frame sequence (e.g. SerializedObject.frames() output).
    return FrameBundle(data).frames


def deserialize(data: "bytes | bytearray | memoryview | FrameBundle | Frames") -> Any:
    """Inverse of :func:`serialize`; zero-copy reads.

    Accepts one contiguous buffer *or* any sequence of frames (a
    :class:`FrameBundle`, ``SerializedObject.frames()`` output, a
    connector's retained frame list) -- consumers never join frames to
    decode.  Array leaves come back as read-only ndarray views over the
    received/mapped segments; only a leaf that straddles a segment
    boundary (misaligned chunking) pays a copy, which is counted.
    """
    sc = _Scattered(_as_segments(data))
    if bytes(sc.read(0, 4)) != MAGIC:
        raise ValueError("not a PSX1 serialized object")
    hlen = int.from_bytes(sc.read(4, 4), "little")
    header = msgpack.unpackb(bytes(sc.read(8, hlen)))
    buffers = _ScatteredSplit(sc, 8 + hlen, header.get("sizes", []))
    kind = header["kind"]
    if kind == "raw":
        return bytes(buffers[0]) if len(buffers) else b""
    if kind == "pickle":
        return _decode_leaf({"k": "pb", "i": 0, "n": header["n"]}, buffers)
    leaves = [_decode_leaf(leaf, buffers) for leaf in header["leaves"]]
    if header["treedef"] is None:
        return leaves[0]
    return _tree_unflatten(pickle.loads(header["treedef"]), leaves)


# -- Pluggable serializer interface -----------------------------------------

def default_serializer(obj: Any) -> SerializedObject:
    return serialize(obj)


def default_deserializer(data: bytes | bytearray | memoryview) -> Any:
    return deserialize(data)


def pickle_serializer(obj: Any) -> SerializedObject:
    """Baseline serializer (plain pickle) used for A/B benchmarks."""
    payload = pickle.dumps(obj, protocol=5)
    header = msgpack.packb({"kind": "pickle", "n": 1, "sizes": [len(payload)]})
    return SerializedObject(header, [memoryview(payload)])


def estimate_size(obj: Any) -> int:
    """Cheap size estimate used by should-proxy policies (no serialization).

    Array-likes report ``nbytes``; containers sum their children recursively;
    everything else uses ``sys.getsizeof``.
    """
    import sys

    arr_nbytes = getattr(obj, "nbytes", None)
    if isinstance(arr_nbytes, int):
        return arr_nbytes
    if isinstance(obj, (bytes, bytearray, memoryview, str)):
        return len(obj)
    if isinstance(obj, (list, tuple, set)):
        return sys.getsizeof(obj) + sum(estimate_size(x) for x in obj)
    if isinstance(obj, dict):
        return sys.getsizeof(obj) + sum(
            estimate_size(k) + estimate_size(v) for k, v in obj.items()
        )
    return sys.getsizeof(obj)
