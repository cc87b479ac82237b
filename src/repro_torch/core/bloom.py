"""Bloom filter [Bloom 1970] -- set membership (port of
``repro/core/bloom.py``).

Parameters per the paper's Table 1: (#elements n, false-positive rate fpr)
=> m = ceil(-n ln fpr / ln(2)^2) bits rounded up to a power of two, and
k = round(m/n ln 2) hash functions (Python's ``round``, half to even, as
in the reference). Bits are int32 0/1 lanes, not packed, so a snapshot
keeps the reference's layout. Merge is elementwise max (== OR on 0/1).

The scatter methods update ``state`` in place (``scatter_reduce_`` with
``amax``) and return it; the reference returns a new array.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing


@dataclasses.dataclass(frozen=True)
class BloomFilter:
    n_elements: int = 10000
    fpr: float = 0.01
    seed: int = 17

    merge_mode = "max"
    update_kernel = "bloom_bitset"       # kernels.ops registry name

    @property
    def log2_bits(self) -> int:
        m = -self.n_elements * math.log(self.fpr) / (math.log(2.0) ** 2)
        return max(3, int(math.ceil(math.log2(max(8.0, m)))))

    @property
    def n_bits(self) -> int:
        return 1 << self.log2_bits

    @property
    def k(self) -> int:
        return max(1, int(round(self.n_bits / self.n_elements * math.log(2.0))))

    def _seeds(self) -> torch.Tensor:
        return hashing.as_u32(hashing.row_seeds(self.seed, self.k))

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.n_bits,), dtype=torch.int32, device=device)

    def _positions(self, items) -> torch.Tensor:
        """int32 bit positions ``[..., k]`` of each item."""
        return hashing.bucket_hash(items, self._seeds(), self.log2_bits)

    def add_batch(self, state, items, values, mask):
        del values
        idx = self._positions(items)
        upd = mask.to(torch.int32)[:, None].expand(idx.shape)
        state.scatter_reduce_(0, idx.reshape(-1).long(), upd.reshape(-1),
                              reduce="amax")
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        """Update a stack ``[n, n_bits]`` routed by ``syn_idx [T]``."""
        del values
        idx = self._positions(items)
        upd = mask.to(torch.int32)[:, None].expand(idx.shape)
        flat = syn_idx.long()[:, None] * self.n_bits + idx.long()
        state.view(-1).scatter_reduce_(0, flat.reshape(-1), upd.reshape(-1),
                                       reduce="amax")
        return state

    def estimate(self, state, items) -> torch.Tensor:
        """Membership queries -- True means 'possibly present'."""
        return torch.all(state[self._positions(items).long()] > 0, dim=-1)

    def stacked_estimate(self, state, rows, items) -> torch.Tensor:
        """Batched membership: query q tests ``items[q]`` against bit
        vector ``rows[q]`` of the stack ``[n, n_bits]`` in one gather."""
        idx = self._positions(items).long()
        return torch.all(state[rows.long()[:, None, None], idx] > 0, dim=-1)

    def merge(self, a, b):
        return torch.maximum(a, b)

    def memory_bytes(self) -> int:
        return self.n_bits // 8
