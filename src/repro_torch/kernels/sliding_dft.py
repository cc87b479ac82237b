"""Batched sliding-DFT tick (StatStream over thousands of streams; port of
``repro/kernels/sliding_dft.py``).

One tick per stream, on the first F DFT coefficients in (re, im) planes:

    X_F <- (X_F + delta) * e^{2 pi i F / n}    where mask > 0

The TPU kernel fuses the six-op complex multiply and the mask into one
VMEM pass; on Hopper ``csrc/sliding_dft.cu`` walks rows instead: a warp
votes on 128 rows' masks and ticks only the rows masked in, with
explicit round-to-nearest intrinsics so that no multiply-add is
contracted and the result equals the plain version
(``ref.sliding_dft_step``) byte for byte.

The tick is in place, on re/im planes at any strides the two share, so
the engine hands it the interleaved ``[S, F, 2]`` coefficient leaf's
views: no copies, and rows that are not masked in are neither read nor
written. It needs no padding. On a CPU tensor it runs the plain version;
on a CUDA tensor it launches the kernel or raises.
``sliding_dft_step.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build, ref

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_SIGNATURES = {
    "dft_tick": (_P, _P, _L, _L, _P, _P, _P, _P, _L, ctypes.c_int, _P),
}


def _lib():
    return build.load("sliding_dft", _SIGNATURES)


def sliding_dft_step(re: torch.Tensor, im: torch.Tensor, delta: torch.Tensor,
                     mask: torch.Tensor, tw_re: torch.Tensor,
                     tw_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """re/im [S, F] f32, ticked in place where mask > 0; delta/mask [S]
    f32, tw_re/tw_im [F] f32. Returns (re, im)."""
    if re.device.type == "cpu":
        return ref.sliding_dft_step(re, im, delta, mask, tw_re, tw_im)
    build.require_cuda(re)
    dev = re.device
    if re.dim() != 2:
        raise ValueError(f"re must be [S, F], got {tuple(re.shape)}")
    s, f = re.shape
    for name, x in (("re", re), ("im", im)):        # strided views
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected "
                            f"torch.float32")
    if tuple(im.shape) != (s, f):
        raise ValueError(f"im has shape {tuple(im.shape)}, expected "
                         f"{(s, f)}")
    if re.stride() != im.stride():
        raise ValueError(f"re and im must share strides, got {re.stride()} "
                         f"and {im.stride()}")
    for name, x, n in (("delta", delta, s), ("mask", mask, s),
                       ("tw_re", tw_re, f), ("tw_im", tw_im, f)):
        build.check(x, name, torch.float32, (n,), dev)
    if s == 0 or f == 0:
        return re, im
    err = _lib().dft_tick(
        re.data_ptr(), im.data_ptr(), re.stride(0), re.stride(1),
        delta.data_ptr(), mask.data_ptr(), tw_re.data_ptr(), tw_im.data_ptr(),
        s, f, build.stream(dev))
    build.check_launch(err, "dft_tick")
    sliding_dft_step.launches += 1
    return re, im


sliding_dft_step.launches = 0
