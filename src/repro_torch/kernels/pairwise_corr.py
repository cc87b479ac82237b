"""All-pairs correlation estimates, the StatStream correlation step (port
of ``repro/kernels/pairwise_corr.py``).

Over the flattened normalized DFT coefficients x [N, K] f32:

    out[i, j] = 1 - (sq_i + sq_j - 2 <x_i, x_j>),  sq_i = <x_i, x_i>

The TPU kernel computes the Gram as an MXU product per 256 x 256 VMEM
block, over inputs padded to its tiles, with ``sq`` computed outside it.
On Hopper the whole formula is one hand-written kernel,
``csrc/pairwise_corr.cu``: a persistent grid over 128 x 64 output tiles
that mask their own ragged edge, each tile staged in shared memory and
stored asynchronously, every output summed in one thread in a fixed
order in float32, so two runs give the same bytes.

On a CPU tensor it runs the plain version (``ref.pairwise_corr``); on a
CUDA tensor it launches the kernel or raises.
``pairwise_corr.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_P = ctypes.c_void_p
_SIGNATURES = {
    "pairwise_corr": (_P, _P, ctypes.c_longlong, ctypes.c_int, _P),
}


def _lib():
    return build.load("pairwise_corr", _SIGNATURES)


def pairwise_corr(x: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, K] f32 contiguous -> correlation estimates [N, N] f32,
    written into ``out`` when given."""
    if x.device.type == "cpu":
        return ref.pairwise_corr(x, out)
    build.require_cuda(x)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x must be [N, K], got {tuple(x.shape)}")
    n, k = x.shape
    build.check(x, "x", torch.float32, (n, k), dev)
    if out is None:
        out = torch.empty((n, n), dtype=torch.float32, device=dev)
    else:
        build.check(out, "out", torch.float32, (n, n), dev)
    if n == 0:
        return out
    err = _lib().pairwise_corr(x.data_ptr(), out.data_ptr(), n, k,
                               build.stream(dev))
    build.check_launch(err, "pairwise_corr")
    pairwise_corr.launches += 1
    return out


pairwise_corr.launches = 0
