"""Plain PyTorch version of the tensor fingerprint.

Counterpart of ``repro/kernels/fingerprint/ref.py::fingerprint_ref``: a
position-salted multiply-xor mix over uint32 lanes, folded to 64 bits.  Not
cryptographic -- it is the content token behind proxy keys and task keys.

Definition (the CUDA kernel must match it bit for bit):

    lanes: data padded with zeros to n_blocks x 4096 bytes,
           read as little-endian uint32 words, (n_blocks, 8, 128)
    acc_0 = SEED ^ lane_salt            (lane_salt = iota * PHI)
    acc_{i+1} = (acc_i * M1) ^ (block_i + (i+1) * PHI)      mod 2**32
    fold: h = xor-reduce(acc * (iota | 1)) over the 8x128 lanes, mixed twice

PyTorch's ``uint32`` has no ``+`` or ``>>`` on the CPU, so the words are
carried in ``int64``.  A product of two 32-bit values may pass 2**63 and
wrap, but its low 32 bits are still the product mod 2**32, and the mix uses
nothing else: only ``*`` and ``^`` touch the accumulator between the masks,
and every shift and every result is taken on values masked to 32 bits.  The
block loop runs in Python, so this version is slow: tens of microseconds
of host time per 4096-byte block, on any device.
"""

from __future__ import annotations

import torch

SEED = 0x9E3779B9
PHI = 0x85EBCA6B
M1 = 0xC2B2AE35
MASK = 0xFFFFFFFF
BLOCK_U32 = 8 * 128          # uint32 lanes per block
BLOCK_BYTES = BLOCK_U32 * 4
CHUNK_BLOCKS = 4096          # blocks widened to int64 at a time (16 MiB of input)


def _as_blocks(data: torch.Tensor) -> torch.Tensor:
    """uint8 1-D -> (n_blocks, 8, 128) int64 holding the uint32 words,
    zero-padded.  The words are read in the machine's byte order, which is
    little-endian on every CUDA host and device, as JAX's bit-cast is."""
    pad = (-data.numel()) % BLOCK_BYTES
    if pad or data.data_ptr() % 4:  # a new buffer is 4-byte aligned
        data = torch.cat([data, data.new_zeros(pad)])
    return (data.view(torch.int32).to(torch.int64) & MASK).reshape(-1, 8, 128)


def _lane_salt(device: torch.device) -> torch.Tensor:
    iota = torch.arange(BLOCK_U32, dtype=torch.int64, device=device).reshape(8, 128)
    return (iota * PHI) & MASK


def _xor_reduce(v: torch.Tensor) -> torch.Tensor:
    """xor of all elements of a 1-D tensor whose length is a power of two."""
    while v.numel() > 1:
        half = v.numel() // 2
        v = v[:half] ^ v[half:]
    return v[0]


def _as_uint32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as torch.uint32."""
    signed = ((v + 2**31) & MASK) - 2**31
    return signed.to(torch.int32).view(torch.uint32)


def _fold(acc: torch.Tensor) -> torch.Tensor:
    """(8, 128) int64 lanes in [0, 2**32) -> (2,) uint32 (a 64-bit token)."""
    lane = torch.arange(BLOCK_U32, dtype=torch.int64, device=acc.device)
    mixed = (acc.reshape(-1) * (lane | 1)) & MASK
    h = _xor_reduce(mixed)
    h2 = _xor_reduce(((mixed ^ (mixed >> 16)) * M1) & MASK)
    h = ((h ^ (h >> 15)) * PHI) & MASK
    h2 = ((h2 ^ (h2 >> 13)) * M1) & MASK
    return _as_uint32(torch.stack([h ^ (h >> 16), h2 ^ (h2 >> 15)]))


def fingerprint_ref(data: torch.Tensor) -> torch.Tensor:
    """data: uint8 1-D, on any device. Returns (2,) uint32 on that device.

    Zero bytes give the folded initial accumulator, as the JAX oracle does.
    """
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"need a 1-D uint8 tensor, got {data.dtype} of shape {tuple(data.shape)}")
    acc = (SEED ^ _lane_salt(data.device)).reshape(-1)
    chunk = CHUNK_BLOCKS * BLOCK_BYTES
    for start in range(0, data.numel(), chunk):
        blocks = _as_blocks(data[start:start + chunk]).reshape(-1, BLOCK_U32)
        first = start // BLOCK_BYTES + 1  # (i+1) of the chunk's first block
        salts = (torch.arange(blocks.shape[0], dtype=torch.int64, device=data.device)
                 + first) * PHI
        for row in ((blocks + salts[:, None]) & MASK).unbind(0):
            acc.mul_(M1).bitwise_xor_(row)
        acc &= MASK
    return _fold(acc.reshape(8, 128))
