"""CountMin sketch [Cormode & Muthukrishnan 2005] (port of
``repro/core/countmin.py``).

Parameters follow the paper's Table 1: (eps, delta) with w = ceil(e/eps)
rounded up to a power of two, and d = ceil(ln(1/delta)). State is a
float32 ``[d, w]`` tensor. Merge is elementwise addition.

The scatter methods update ``state`` in place (``index_put_`` with
``accumulate=True``) and return it; the reference returns a new array.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing


def _pow2_at_least(x: float) -> int:
    return max(1, int(math.ceil(math.log2(max(2.0, x)))))


@dataclasses.dataclass(frozen=True)
class CountMin:
    eps: float = 0.01
    delta: float = 0.01
    seed: int = 7
    weighted: bool = True   # value-weighted counts (paper uses counts of bids)

    merge_mode = "sum"
    update_kernel = "countmin_scatter"   # kernels.ops registry name

    @property
    def depth(self) -> int:
        return max(1, int(math.ceil(math.log(1.0 / self.delta))))

    @property
    def log2_width(self) -> int:
        return _pow2_at_least(math.e / self.eps)

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    def _seeds(self) -> torch.Tensor:
        return hashing.as_u32(hashing.row_seeds(self.seed, self.depth))

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.depth, self.width), dtype=torch.float32,
                           device=device)

    def _weights(self, values, mask) -> torch.Tensor:
        v = values if self.weighted else torch.ones_like(values)
        return v * mask.to(torch.float32)

    def add_batch(self, state, items, values, mask) -> torch.Tensor:
        idx = hashing.bucket_hash(items, self._seeds(), self.log2_width)
        v = self._weights(values, mask)[:, None].expand(idx.shape)
        rows = torch.arange(self.depth, device=state.device)[None, :]
        state.index_put_((rows.expand(idx.shape), idx.long()), v,
                         accumulate=True)
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        """Update a stack ``[n, d, w]`` routed by ``syn_idx [T]``."""
        idx = hashing.bucket_hash(items, self._seeds(), self.log2_width)
        v = self._weights(values, mask)[:, None].expand(idx.shape)
        rows = torch.arange(self.depth, device=state.device)[None, :]
        state.index_put_((syn_idx.long()[:, None].expand(idx.shape),
                          rows.expand(idx.shape), idx.long()), v,
                         accumulate=True)
        return state

    def estimate(self, state, items) -> torch.Tensor:
        """Point frequency query for a batch of items."""
        idx = hashing.bucket_hash(items, self._seeds(), self.log2_width)
        rows = torch.arange(self.depth, device=state.device)[None, :]
        return state[rows, idx.long()].amin(dim=-1)

    def stacked_estimate(self, state, rows, items) -> torch.Tensor:
        """Batched point queries against a stack ``[n, d, w]``: query q
        reads row ``rows[q]`` for its own ``items[q]`` -- one gather."""
        idx = hashing.bucket_hash(items, self._seeds(), self.log2_width)
        d_idx = torch.arange(self.depth, device=state.device)[None, None, :]
        return state[rows.long()[:, None, None], d_idx,
                     idx.long()].amin(dim=-1)

    def merge(self, a, b):
        return a + b

    def memory_bytes(self) -> int:
        return self.depth * self.width * 4
