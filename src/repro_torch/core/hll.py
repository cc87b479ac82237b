"""HyperLogLog [Flajolet et al. 2007] (port of ``repro/core/hll.py``).

p = ceil(log2((1.04 / rse)**2)) clamped to [4, 18]; state is ``2**p``
int32 registers, each the max leading-zero rank seen. Merge is an
elementwise max. The scatter methods update ``state`` in place.

The estimate runs in float32 like the reference's; ``exp2``, the sum and
``log`` may round differently in the last place, so answers agree with
the JAX package to ``rtol=1e-6``, not byte for byte.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


@dataclasses.dataclass(frozen=True)
class HyperLogLog:
    rse: float = 0.0325          # default ~ p=10
    seed: int = 11

    merge_mode = "max"
    update_kernel = "hll_max"    # kernels.ops registry name

    @property
    def p(self) -> int:
        return max(4, min(18, int(math.ceil(math.log2((1.04 / self.rse) ** 2)))))

    @property
    def m(self) -> int:
        return 1 << self.p

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.m,), dtype=torch.int32, device=device)

    def _bucket_rank(self, items):
        """(bucket, rank) int32 per item: the top ``p`` hash bits pick the
        register, the leading zeros of the rest + 1 are the rank."""
        h = hashing.hash_u32(items, self.seed)
        bucket = (h >> (32 - self.p)).to(torch.int32)
        rest = (h << self.p) & hashing.MASK32
        rank = torch.where(rest == 0, 32 - self.p + 1,
                           hashing.clz32(rest) + 1).to(torch.int32)
        return bucket, rank

    def add_batch(self, state, items, values, mask):
        del values
        bucket, rank = self._bucket_rank(items)
        rank = torch.where(mask, rank, 0).to(torch.int32)
        state.scatter_reduce_(0, bucket.long(), rank, reduce="amax")
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        del values
        bucket, rank = self._bucket_rank(items)
        rank = torch.where(mask, rank, 0).to(torch.int32)
        flat = syn_idx.long() * self.m + bucket.long()
        state.view(-1).scatter_reduce_(0, flat, rank, reduce="amax")
        return state

    def _estimate_regs(self, regs) -> torch.Tensor:
        m = float(self.m)
        raw = _alpha(self.m) * m * m / torch.sum(
            torch.exp2(-regs.to(torch.float32)), dim=-1)
        zeros = torch.sum(regs == 0, dim=-1).to(torch.float32)
        # linear counting small-range correction
        lc = m * torch.log(m / torch.clamp(zeros, min=1.0))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), lc, raw)

    def estimate(self, state) -> torch.Tensor:
        return self._estimate_regs(state)

    def stacked_estimate(self, state, rows) -> torch.Tensor:
        """Cardinality of each requested row of a register stack [n, m]."""
        return self._estimate_regs(state[rows.long()])

    def merge(self, a, b):
        return torch.maximum(a, b)

    def memory_bytes(self) -> int:
        return self.m * 4
