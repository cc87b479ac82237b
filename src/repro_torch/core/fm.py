"""FM sketch [Flajolet & Martin 1985] -- distinct count via PCSA bitmaps
(port of ``repro/core/fm.py``).

``nmaps`` bitmaps of ``bitmap_size`` int32 0/1 lanes; each item selects a
bitmap (top hash bits) and sets bit rho = trailing zeros of the same
hash, clamped to ``bitmap_size - 1``. The estimate is the PCSA formula
``nmaps / phi * 2**mean(R)`` with R the lowest unset bit per bitmap.
Merge is elementwise max (== bitmap OR on 0/1).

Differences from the reference:

  * The scatter methods update ``state`` in place.
  * ``_which_pos`` shifts an int64 tensor holding uint32 values, so the
    shift by 32 that ``nmaps = 1`` asks for gives 0, as XLA's does.
  * ``torch.argmax`` takes no bool tensor on the CPU: the unset mask is
    cast to int32 first (the first maximum wins in both frameworks).
  * ``exp2`` of the float32 mean may round differently in the last
    place, so estimates agree with the JAX package to ``rtol=1e-6``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing

_PHI = 0.77351


@dataclasses.dataclass(frozen=True)
class FMSketch:
    bitmap_size: int = 32
    nmaps: int = 64          # averaging maps: rse ~ 0.78/sqrt(nmaps)
    seed: int = 19

    merge_mode = "max"       # bitmap OR == max on {0,1}
    update_kernel = "fm_bitmap"          # kernels.ops registry name

    @property
    def log2_nmaps(self) -> int:
        return int(math.log2(self.nmaps))

    def __post_init__(self):
        if 1 << int(math.log2(self.nmaps)) != self.nmaps:
            raise ValueError("nmaps must be a power of two")

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.nmaps, self.bitmap_size), dtype=torch.int32,
                           device=device)

    def _which_pos(self, items):
        """Bitmap selector = top bits; geometric position = trailing zeros
        of the low bits (disjoint bit ranges of one mixed hash)."""
        h = hashing.hash_u32(items, self.seed)
        which = (h >> (32 - self.log2_nmaps)).to(torch.int32)
        pos = torch.clamp(hashing.ctz32(h), max=self.bitmap_size - 1)
        return which, pos

    def _flat(self, which, pos) -> torch.Tensor:
        return which.long() * self.bitmap_size + pos.long()

    def add_batch(self, state, items, values, mask):
        del values
        which, pos = self._which_pos(items)
        state.view(-1).scatter_reduce_(0, self._flat(which, pos),
                                       mask.to(torch.int32), reduce="amax")
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        """Update a stack ``[n, nmaps, bitmap_size]`` routed by
        ``syn_idx [T]``."""
        del values
        which, pos = self._which_pos(items)
        flat = syn_idx.long() * (self.nmaps * self.bitmap_size) \
            + self._flat(which, pos)
        state.view(-1).scatter_reduce_(0, flat, mask.to(torch.int32),
                                       reduce="amax")
        return state

    def _estimate_maps(self, maps) -> torch.Tensor:
        unset = (maps == 0).to(torch.int32)                 # [..., maps, bits]
        first_unset = torch.argmax(unset, dim=-1)
        all_set = ~torch.any(unset.bool(), dim=-1)
        r = torch.where(all_set, self.bitmap_size,
                        first_unset).to(torch.float32)
        return self.nmaps / _PHI * torch.exp2(torch.mean(r, dim=-1))

    def estimate(self, state) -> torch.Tensor:
        return self._estimate_maps(state)

    def stacked_estimate(self, state, rows) -> torch.Tensor:
        """PCSA estimate of each requested row of a stack
        ``[n, nmaps, bitmap_size]``."""
        return self._estimate_maps(state[rows.long()])

    def merge(self, a, b):
        return torch.maximum(a, b)

    def memory_bytes(self) -> int:
        return self.nmaps * self.bitmap_size // 8
