"""Plain PyTorch versions of the hand-written kernels (port of the two
scatter oracles in ``repro/kernels/ref.py``).

The wrappers run these on CPU tensors; ``chip_smoke.py`` holds each CUDA
kernel against them on the card. Both update in place.

Unlike the reference oracle, whose ``.at[-1]`` wraps a ``syn_idx = -1``
tuple onto the LAST row, these drop rows outside ``[0, n)``, as the
kernels and the engine's own path (``core/batched.py``) do.
"""
from __future__ import annotations

from typing import Optional

import torch


def onehot_scatter_add(counts: torch.Tensor, syn_idx: torch.Tensor,
                       idx: torch.Tensor, values: torch.Tensor,
                       signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``counts[s, j, idx[t, j]] += values[t] * signs[t, j]`` for every
    tuple t with ``syn_idx[t] = s`` in ``[0, n)``; ``signs=None`` means +1.
    counts [n, d, w] f32; syn_idx [T] i32; idx [T, d] i32; values [T] f32;
    signs [T, d] f32."""
    n, d, _ = counts.shape
    keep = (syn_idx >= 0) & (syn_idx < n)
    ix = idx[keep].long()
    v = values[keep][:, None]
    v = v.expand(ix.shape) if signs is None else v * signs[keep]
    rows = syn_idx[keep].long()[:, None].expand(ix.shape)
    js = torch.arange(d, device=counts.device)[None, :].expand(ix.shape)
    counts.index_put_((rows, js, ix), v.contiguous(), accumulate=True)
    return counts


def hll_max_update(regs: torch.Tensor, syn_idx: torch.Tensor,
                   bucket: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """``regs[s, bucket[t]] = max(regs[s, bucket[t]], rank[t])`` for every
    tuple t with ``syn_idx[t] = s`` in ``[0, n)``; rank 0 is a no-op.
    regs [n, m] i32; syn_idx/bucket/rank [T] i32."""
    n, m = regs.shape
    keep = (syn_idx >= 0) & (syn_idx < n)
    flat = syn_idx[keep].long() * m + bucket[keep].long()
    regs.view(-1).scatter_reduce_(0, flat, rank[keep], reduce="amax")
    return regs
