"""Random Hyperplane Projection (RHP / SimHash) [Charikar 2002; Giatrakos
et al. 2013] -- cosine-similarity LSH bitmaps (port of
``repro/core/rhp.py``).

State: b running dot products of the stream's frequency/feature vector v
with b +-1 hyperplanes, a float32 ``[b]`` tensor (linear in v, so
incremental and mergeable by addition). The bitmap is sign(dots); the
Hamming distance between bitmaps estimates the angle:
``cos_sim ~= cos(pi * ham / b)``. ``bucket_of`` packs the first g bits
into a bucket id.

Differences from the reference:

  * ``stacked_add_batch`` updates ``state`` in place (``index_add_``).
    It is the plain, kind-level update of ``batched.stacked_update``;
    the engine's path goes through the registry kernel
    (``kernels/rhp_project.py``).
  * ``hamming_weight`` and ``bucket`` are cast to int32, the dtype of
    the reference's ``jnp.sum`` over int32 (``torch.sum`` gives int64).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import hashing


@dataclasses.dataclass(frozen=True)
class RHP:
    n_bits: int = 64           # bitmap size
    threshold: float = 0.9     # similarity threshold (for candidate pruning)
    bucket_bits: int = 8       # leading bits forming the bucket id
    seed: int = 29

    merge_mode = "sum"
    update_kernel = "rhp_project"        # kernels.ops registry name

    def _seeds(self) -> torch.Tensor:
        return hashing.as_u32(hashing.row_seeds(self.seed, self.n_bits))

    def init(self, device) -> torch.Tensor:
        return torch.zeros((self.n_bits,), dtype=torch.float32,
                           device=device)

    def add_batch(self, state, items, values, mask) -> torch.Tensor:
        sgn = hashing.sign_hash(items, self._seeds())           # [T, b]
        v = (values * mask.to(torch.float32))[:, None]
        state += torch.sum(sgn * v, dim=0)
        return state

    def stacked_add_batch(self, state, syn_idx, items, values, mask):
        """Update a stack ``[n, b]`` routed by ``syn_idx [T]`` (clamped to
        row 0 and up; the mask is folded into the weights)."""
        sgn = hashing.sign_hash(items, self._seeds())
        v = (values * mask.to(torch.float32))[:, None]
        state.index_add_(0, syn_idx.long(), sgn * v)
        return state

    def signature(self, state) -> torch.Tensor:
        return (state > 0).to(torch.int32)

    def estimate(self, state) -> dict:
        sig = self.signature(state)
        return dict(signature=sig,
                    hamming_weight=torch.sum(sig).to(torch.int32),
                    bucket=self.bucket_of(sig))

    def stacked_estimate(self, state, rows) -> dict:
        """Signature/bucket of each requested row of a stack ``[n, b]``."""
        sig = self.signature(state[rows.long()])                # [N, b]
        return dict(signature=sig,
                    hamming_weight=torch.sum(sig, dim=-1).to(torch.int32),
                    bucket=self.bucket_of(sig))

    def bucket_of(self, sig) -> torch.Tensor:
        g = self.bucket_bits
        mult = torch.tensor([1 << i for i in range(g)], dtype=torch.int32,
                            device=sig.device)
        return torch.sum(sig[..., :g] * mult, dim=-1).to(torch.int32)

    def merge(self, a, b):
        return a + b     # dot products are linear in the stream

    def memory_bytes(self) -> int:
        return self.n_bits * 4


def cosine_similarity(sig_a, sig_b, n_bits: int) -> torch.Tensor:
    ham = torch.sum(torch.abs(sig_a - sig_b), dim=-1).to(torch.float32)
    return torch.cos(math.pi * ham / n_bits)
