"""Streaming-softmax attention forward (port of
``repro/kernels/flash_attention.py``).

    out = softmax(q k^T / sqrt(D) [+ causal mask]) v

over q [BH, Sq, D] and k, v [BH, Sk, D], all float32 or all bfloat16,
with the output in q's dtype. ``causal`` masks by absolute positions from
the top left (key position <= query position), as the Pallas body does.

The TPU kernel walks a sequential (BH, Sq/bq, Sk/bk) grid with the
running max, denominator and float32 accumulator in VMEM scratch, over
inputs padded to its blocks. On Hopper it is one hand-written kernel,
``csrc/flash_attention.cu``: a block owns a query tile and loops over the
key tiles (skipping those wholly above the causal diagonal), masks its
own ragged edge, and keeps the scores out of device memory. bfloat16 is
warp-specialised: one producer warp loads Q once and K/V tiles through a
ring of shared-memory stages by TMA (3-D tensor maps, so a ragged Sk
reads zeros, never the next head), and two consumer warpgroups of 64
query rows run both products on ``wgmma`` with float32 accumulators;
float32 runs on the CUDA cores. No atomics and no split over keys: two
runs give the same bytes.

Arithmetic, bfloat16: the reference multiplies a float32 p by v cast to
float32; the bf16 tensor cores take bf16 operands only, so the kernel
feeds p to P.V as two bf16 parts, hi (p with its low 16 bits cleared)
and lo = bf16(p - hi), which carry 16 of p's 24 significant bits
(relative error under 2**-16). Scores, sums, the running max and
denominator stay float32.

Contract, both on the CPU and on the card: rank 3, one dtype (float32 or
bfloat16) for q, k and v, matching BH and D, Sq and Sk >= 1, and D a
multiple of 16 from 16 to 256 (Gemma-7B's head_dim of 256 is the widest
the configs name); anything else raises ``ValueError``. The reference
takes any D. On a CPU tensor it runs the plain version
(``ref.flash_attention``); on a CUDA tensor it launches the kernel or
raises. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P),
}
DTYPES = (torch.float32, torch.bfloat16)
D_MAX = 256


def _lib():
    return build.load("flash_attention", _SIGNATURES)


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(BH, Sq, Sk, D) of a call the kernel takes; ``ValueError`` else."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, D], got "
                             f"{tuple(x.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (bh, sk, d) or tuple(v.shape) != (bh, sk, d):
        raise ValueError(f"k and v must be [{bh}, Sk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if bh < 1 or sq < 1 or sk < 1:
        raise ValueError(f"BH, Sq and Sk must be >= 1, got {bh}, {sq}, {sk}")
    if d % 16 or not 16 <= d <= D_MAX:
        raise ValueError(f"head dim {d} is not a multiple of 16 from 16 to "
                         f"{D_MAX}")
    return bh, sq, sk, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH, Sk, D] contiguous -> [BH, Sq, D] in q's
    dtype, written into ``out`` when given."""
    bh, sq, sk, d = _check_operands(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, out)
    build.require_cuda(q)
    dev, dtype = q.device, q.dtype
    build.check(q, "q", dtype, (bh, sq, d), dev)
    build.check(k, "k", dtype, (bh, sk, d), dev)
    build.check(v, "v", dtype, (bh, sk, d), dev)
    if out is None:
        out = torch.empty((bh, sq, d), dtype=dtype, device=dev)
    else:
        build.check(out, "out", dtype, (bh, sq, d), dev)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk,
        d, int(bool(causal)), int(dtype == torch.bfloat16), build.stream(dev))
    build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
