"""Vectorized 32-bit hash families (port of ``repro/core/hashing.py``).

The JAX module computes in ``uint32`` lanes. PyTorch on the CPU has no
``>>`` on ``torch.uint32``, so this port carries every uint32 value in an
``int64`` tensor holding ``[0, 2**32)`` and masks with ``0xFFFFFFFF``
after each step that can leave that range. Multiplies are split into
16-bit halves so no product leaves the signed 64-bit range: the results
are bit-identical to the reference's wrapping uint32 arithmetic.

Inputs may be int32 bit patterns (how uint32 halves reach the kernels),
int64 or uint32 values; :func:`as_u32` normalizes all of them.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# murmur3 32-bit finalizer constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def as_u32(x) -> torch.Tensor:
    """uint32 values as an int64 tensor in ``[0, 2**32)``. int32 bit
    patterns (negative for values >= 2**31) map to their uint32 value."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x).astype(np.int64))
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``(x * c) mod 2**32`` for uint32 values held in int64 (``c`` an int
    or a tensor of uint32 values); no intermediate exceeds 2**49."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32: a high-quality 32-bit bijective mixer."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def hash_u32(x, seed) -> torch.Tensor:
    """Seeded full-width 32-bit hash of integer identities."""
    x = as_u32(x)
    if isinstance(seed, torch.Tensor):
        seed = as_u32(seed)
    else:
        seed = int(seed) & MASK32
    return mix32(x ^ ((mul32(seed, _GOLDEN) + 1) & MASK32))


def row_seeds(base_seed: int, rows: int) -> np.ndarray:
    """Deterministic per-row seeds for a d-row sketch (host-side constant)."""
    rng = np.random.RandomState(base_seed)
    return rng.randint(1, 2**31 - 1, size=(rows,), dtype=np.int64).astype(np.uint32)


def bucket_hash(x, seeds, log2_width: int) -> torch.Tensor:
    """Map items ``x[T]`` to int32 buckets ``[T, d]`` in
    ``[0, 2**log2_width)`` by multiply-shift over the mixed identity (the
    top ``log2_width`` bits of ``a * mix(x ^ seed)``, 2-universal for odd
    ``a``)."""
    x = as_u32(x)
    seeds = as_u32(seeds).to(x.device)
    h = hash_u32(x[..., None], seeds)                   # [T, d]
    a = (seeds * 2 + 1) & MASK32                        # odd multipliers
    v = mul32(h, a)
    return (v >> (32 - log2_width)).to(torch.int32)


def sign_hash(x, seeds) -> torch.Tensor:
    """float32 +-1 signs ``[T, d]`` for AMS/count-sketch style updates."""
    x = as_u32(x)
    seeds = as_u32(seeds).to(x.device)
    h = hash_u32(x[..., None], seeds ^ 0xA5A5A5A5)
    bit = (h >> 31).to(torch.float32)
    return 1.0 - 2.0 * bit


def uniform01(x, seed) -> torch.Tensor:
    """Deterministic per-item uniform(0,1) float32 from identities."""
    h = hash_u32(x, seed)
    return h.to(torch.float32) * np.float32(1.0 / 4294967296.0)


def clz32(x) -> torch.Tensor:
    """Count leading zeros of uint32 (32 for x == 0), as int32."""
    y = as_u32(x)
    bits = torch.zeros_like(y)
    for s in (16, 8, 4, 2, 1):
        t = y >> s
        big = t > 0
        bits = bits + big.to(torch.int64) * s
        y = torch.where(big, t, y)
    bits = bits + (y > 0).to(torch.int64)
    return (32 - bits).to(torch.int32)


def ctz32(x) -> torch.Tensor:
    """Count trailing zeros of uint32 (32 for x == 0), as int32."""
    x = as_u32(x)
    low = x & ((~x + 1) & MASK32)        # isolate the lowest set bit
    return torch.where(x == 0, 32, 31 - clz32(low)).to(torch.int32)
