"""AMS sketch [Alon, Matias, Szegedy 1996] -- L2 norm / inner product
(port of ``repro/core/ams.py``).

Fast-AMS / count-sketch layout: d independent rows of w counters; each
update adds sign_j(x) * v to counter [j, h_j(x)]. Row estimate of <u, v>
is the row dot product; the final estimate is the median over rows.
w = O(1/eps^2) rounded up to a power of two, d = O(log 1/delta). Merge is
elementwise addition.

The scatter methods update ``state`` in place (``index_put_`` with
``accumulate=True``) and return it; the reference returns a new array.
Every median is :func:`median_last`, which averages the two middle rows
as ``jnp.median`` does (``torch.median`` returns the lower one).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing


def median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as ``jnp.median`` computes it: the sorted
    values' middle two, ``(v[(d-1)//2] + v[d//2]) * 0.5`` in float32 (at
    odd d the one middle value, as ``(x + x) * 0.5``)."""
    v = torch.sort(x, dim=-1).values
    d = v.shape[-1]
    return (v[..., (d - 1) // 2] + v[..., d // 2]) * 0.5


@dataclasses.dataclass(frozen=True)
class AMS:
    eps: float = 0.05
    delta: float = 0.05
    seed: int = 13

    merge_mode = "sum"
    update_kernel = "ams_scatter"        # kernels.ops registry name

    @property
    def depth(self) -> int:
        return max(1, int(math.ceil(4.0 * math.log(1.0 / self.delta))))

    @property
    def log2_width(self) -> int:
        return max(1, int(math.ceil(math.log2(max(2.0, 4.0 / self.eps ** 2)))))

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    def _seeds(self) -> torch.Tensor:
        return hashing.as_u32(hashing.row_seeds(self.seed, self.depth))

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.depth, self.width), dtype=torch.float32,
                           device=device)

    def _hash(self, items):
        """int32 buckets and float32 +-1 signs ``[T, d]`` of the items."""
        seeds = self._seeds()
        return (hashing.bucket_hash(items, seeds, self.log2_width),
                hashing.sign_hash(items, seeds))

    def add_batch(self, state, items, values, mask) -> torch.Tensor:
        idx, sgn = self._hash(items)
        v = (values * mask.to(torch.float32))[:, None] * sgn
        rows = torch.arange(self.depth, device=state.device)[None, :]
        state.index_put_((rows.expand(idx.shape), idx.long()), v,
                         accumulate=True)
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        """Update a stack ``[n, d, w]`` routed by ``syn_idx [T]``."""
        idx, sgn = self._hash(items)
        v = (values * mask.to(torch.float32))[:, None] * sgn
        rows = torch.arange(self.depth, device=state.device)[None, :]
        state.index_put_((syn_idx.long()[:, None].expand(idx.shape),
                          rows.expand(idx.shape), idx.long()), v,
                         accumulate=True)
        return state

    def add_dense(self, state, vec) -> torch.Tensor:
        """Sketch a dense vector (gradient sketching): item ids are the
        positions (int32 bit patterns)."""
        items = torch.arange(vec.shape[0], dtype=torch.int32,
                             device=vec.device)
        return self.add_batch(state, items, vec,
                              torch.ones(vec.shape, dtype=torch.bool,
                                         device=vec.device))

    def estimate(self, state) -> torch.Tensor:
        """L2-norm^2 estimate (self inner product)."""
        return self.inner_product(state, state)

    def stacked_estimate(self, state, rows) -> torch.Tensor:
        """L2-norm^2 of each requested row of a stack ``[n, d, w]``."""
        sub = state[rows.long()]                               # [N, d, w]
        return median_last(torch.sum(sub * sub, dim=-1))

    def inner_product(self, a, b) -> torch.Tensor:
        return median_last(torch.sum(a * b, dim=-1))

    def point_query(self, state, items) -> torch.Tensor:
        """Count-sketch point frequency estimate (median of sign*counter)."""
        idx, sgn = self._hash(items)
        rows = torch.arange(self.depth, device=state.device)[None, :]
        return median_last(state[rows, idx.long()] * sgn)

    def merge(self, a, b):
        return a + b

    def memory_bytes(self) -> int:
        return self.depth * self.width * 4
