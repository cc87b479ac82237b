"""Chain / reservoir sampler [Babcock, Datar, Motwani 2002] -- a uniform
sample of a stream (port of ``repro/core/sampler.py``).

Whole-stream mode is Vitter's reservoir-R with counter-based randomness,
so the sample is a pure function of the stream. A tuple that arrives
when the reservoir of S slots has seen n tuples draws

    u = uniform01(((n * 2654435761) mod 2**32) ^ item, seed)
    j = int32(u * float32(n + 1))        (a float32 product, truncated)

and takes slot n while n < S, else slot j when j < S; every valid tuple
adds one to n. A slot's value is its last writer's.

State is three leaves: ``values`` float32 ``[S]``, ``items`` int32
``[S]`` (the uint32 identities as int32 bit patterns, as items travel
through the engine) and ``n_seen`` an int32 scalar.

Differences from the reference:

  * ``add_batch`` updates ``state`` in place and skips masked tuples (a
    masked step of the reference writes its slot back unchanged and
    leaves ``n_seen``).
  * There is no ``stacked_add_batch``: the engine updates a stack through
    the registry kernel ``"reservoir_scan"`` (``kernels/ops.py``, the
    routing probe fused in unless ``SDE_FUSED_PROBE`` is off), and
    ``batched.stacked_update`` through :meth:`ReservoirSampler.scan_update`;
    both group the batch by row (the hand-written kernel of
    ``kernels/reservoir_scan.py`` on the card), where the reference vmaps
    ``add_batch`` over every row with the whole batch masked.
  * ``estimate`` and ``stacked_estimate`` answer ``items`` as
    ``torch.uint32`` (the int32 bits viewed), so an answer brought to the
    host is the reference's uint32 array and ids of 2**31 and above stay
    positive.
"""
from __future__ import annotations

import dataclasses

import torch

from . import hashing

# the multiplier of n in the step's hash: 0x9E3779B1, not hashing._GOLDEN
# (0x9E3779B9)
N_MULT = 2654435761


def slots_of(n: torch.Tensor, items: torch.Tensor, sample_size: int,
             seed: int):
    """(slot, write) of tuples that arrive when the reservoir has seen
    ``n`` (int64, below 2**31 - 1) with identities ``items`` (int32 bits
    or uint32 values): the reference's ``_step`` arithmetic, with the
    multiply wrapping mod 2**32 before the xor, u times float32(n + 1)
    rounded to float32 and truncated toward zero."""
    x = hashing.mul32(hashing.as_u32(n), N_MULT) ^ hashing.as_u32(items)
    u = hashing.uniform01(x, seed)
    j = (u * (n + 1).to(torch.float32)).to(torch.int32)
    fill = n < sample_size
    return torch.where(fill, n, j), fill | (j < sample_size)


def sample_row(values: torch.Tensor, items: torch.Tensor,
               n_seen: torch.Tensor, in_items: torch.Tensor,
               in_values: torch.Tensor, seed: int) -> None:
    """One reservoir's steps over ``in_items`` / ``in_values`` (all valid)
    in order, in place. Tuple i arrives at ``n_seen + i``, whatever the
    state holds, so each tuple's slot is computed at once; the writes then
    go in batch order, a later one overwriting an earlier one."""
    t = in_items.shape[0]
    if t == 0:
        return
    n = n_seen.to(torch.int64) + torch.arange(t, device=n_seen.device)
    slot, write = slots_of(n, in_items, values.shape[0], seed)
    at = torch.nonzero(write)[:, 0]
    for i, s in zip(at.tolist(), slot[at].tolist()):
        values[s] = in_values[i]
        items[s] = in_items[i]
    n_seen += t


@dataclasses.dataclass(frozen=True)
class ReservoirSampler:
    sample_size: int = 64
    seed: int = 41

    merge_mode = "gather"
    update_kernel = "reservoir_scan"     # kernels.ops registry name

    def init(self, device) -> dict:
        s = self.sample_size
        return dict(
            values=torch.zeros((s,), dtype=torch.float32, device=device),
            items=torch.zeros((s,), dtype=torch.int32, device=device),
            n_seen=torch.zeros((), dtype=torch.int32, device=device))

    def add_batch(self, state, items, values, mask) -> dict:
        """The one-row sampler (a plain loop of writes), in place."""
        sample_row(state["values"], state["items"], state["n_seen"],
                   items[mask], values.to(torch.float32)[mask], self.seed)
        return state

    def scan_update(self, state, syn_idx, items, values, mask,
                    source_rows=None) -> dict:
        """Update a stack ``{values, items: [n, S], n_seen: [n]}`` in place:
        row r takes the tuples with ``mask & (syn_idx == r)``, a
        data-source row (``source_rows``) every tuple with ``mask``, each
        in batch order; other rows are untouched. The hand-written
        reservoir kernel on the card, its plain version on the CPU."""
        from repro_torch.kernels import reservoir_scan   # kernels import core
        reservoir_scan.reservoir_scan_update(
            state["values"], state["items"], state["n_seen"], syn_idx,
            items, values, mask, source_rows, seed=self.seed)
        return state

    def estimate(self, state) -> dict:
        """The sample: ``values``, ``items`` (uint32) and which slots hold
        one (``valid``: the first min(n_seen, S))."""
        k = torch.clamp(state["n_seen"], max=self.sample_size)
        valid = torch.arange(self.sample_size, device=k.device) < k
        return dict(values=state["values"],
                    items=state["items"].view(torch.uint32), valid=valid)

    def stacked_estimate(self, state, rows) -> dict:
        """Samples of each requested row of the stacked reservoirs."""
        r = rows.long()
        k = torch.clamp(state["n_seen"][r], max=self.sample_size)   # [N]
        valid = (torch.arange(self.sample_size, device=k.device)[None, :]
                 < k[:, None])
        return dict(values=state["values"][r],
                    items=state["items"][r].view(torch.uint32), valid=valid)

    def merge(self, a, b) -> dict:
        """Weighted reservoir merge: slot i keeps a's item with probability
        n_a / (n_a + n_b) -- an unbiased union sample."""
        na = a["n_seen"].to(torch.float32)
        nb = b["n_seen"].to(torch.float32)
        p = na / torch.maximum(na + nb, torch.ones_like(na))
        total = hashing.as_u32(a["n_seen"] + b["n_seen"])
        u = hashing.uniform01(
            torch.arange(self.sample_size, device=na.device) ^ total,
            self.seed + 2)
        take_a = u < p
        return dict(
            values=torch.where(take_a, a["values"], b["values"]),
            items=torch.where(take_a, a["items"], b["items"]),
            n_seen=a["n_seen"] + b["n_seen"])

    def memory_bytes(self) -> int:
        return self.sample_size * 8
