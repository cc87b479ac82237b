"""Lossy Counting [Manku & Motwani 2002] -- frequent items and their
counts (port of ``repro/core/lossy.py``).

As in the reference, the fixed-table Misra-Gries / Space-Saving variant
with k = ceil(1/eps) slots: a tuple adds its weight to its item's slot,
else takes the first empty slot, else evicts the first slot of least
count (whose count becomes the newcomer's base and its error). Over-count
is at most N/k <= eps*N, and the tables are mergeable.

State is three ``[k]`` leaves: ``keys`` holds the uint32 item identities
as int32 bit patterns (the empty sentinel 0xFFFFFFFF is ``-1``), as items
travel through the engine; ``counts`` and ``error`` are float32.

Differences from the reference:

  * ``add_batch`` updates ``state`` in place and skips masked tuples (a
    masked step of the reference writes every slot back unchanged).
  * There is no ``stacked_add_batch``: a stack is updated by
    :meth:`LossyCounting.scan_update`, which groups the batch by row and
    scans each row's own tuples (the hand-written kernel of
    ``kernels/lossy_scan.py`` on the card), where the reference vmaps
    ``add_batch`` over every row with the whole batch masked.
"""
from __future__ import annotations

import dataclasses
import math

import torch

EMPTY = -1      # int32 bits of the reference's uint32 sentinel 0xFFFFFFFF


def scan_row(keys: torch.Tensor, counts: torch.Tensor, error: torch.Tensor,
             items: torch.Tensor, values: torch.Tensor) -> None:
    """One table's scan over ``items`` / ``values`` in order, in place:
    the reference's ``_step`` for each (valid) tuple. The item's slot if
    it is tracked, else the first empty slot, else the first slot of least
    count (``argmin`` returns the first). An item whose bits are the
    sentinel "hits" every empty slot, as in the reference: its weight goes
    into the first one, whose key stays empty."""
    for item, v in zip(items, values):
        hit = keys == item
        empty = keys == EMPTY
        any_hit, any_empty = hit.any(), empty.any()
        slot = torch.where(any_hit, hit.to(torch.uint8).argmax(),
                           torch.where(any_empty,
                                       empty.to(torch.uint8).argmax(),
                                       counts.argmin()))
        c = counts[slot]
        evict = ~(any_hit | any_empty)
        base = torch.where(any_hit | evict, c, 0.0)
        error[slot] = torch.where(evict, c, error[slot])
        keys[slot] = item
        counts[slot] = base + v


@dataclasses.dataclass(frozen=True)
class LossyCounting:
    eps: float = 0.01
    seed: int = 31

    merge_mode = "gather"

    @property
    def k(self) -> int:
        return max(4, int(math.ceil(1.0 / self.eps)))

    def init(self, device) -> dict:
        return dict(
            keys=torch.full((self.k,), EMPTY, dtype=torch.int32,
                            device=device),
            counts=torch.zeros((self.k,), dtype=torch.float32,
                               device=device),
            error=torch.zeros((self.k,), dtype=torch.float32,
                              device=device))

    def add_batch(self, state, items, values, mask) -> dict:
        """The one-row scan (a plain loop of tuples), in place."""
        scan_row(state["keys"], state["counts"], state["error"],
                 items[mask], values.to(torch.float32)[mask])
        return state

    def scan_update(self, state, syn_idx, items, values, mask,
                    source_rows=None) -> dict:
        """Update a stack ``{keys, counts, error}: [n, k]`` in place: row r
        scans the tuples with ``mask & (syn_idx == r)``, a data-source row
        (``source_rows``) every tuple with ``mask``, each in batch order;
        other rows are untouched. The hand-written scan kernel on the card,
        its plain version on the CPU."""
        from repro_torch.kernels import lossy_scan     # kernels import core
        lossy_scan.lossy_scan_update(state["keys"], state["counts"],
                                     state["error"], syn_idx, items,
                                     values, mask, source_rows)
        return state

    def estimate(self, state, items) -> torch.Tensor:
        """Frequency estimates (0 when not tracked); over-count <= eps*N."""
        eq = state["keys"][None, :] == items[:, None]
        return torch.where(eq, state["counts"][None, :], 0.0).sum(dim=-1)

    def stacked_estimate(self, state, rows, items) -> torch.Tensor:
        """Batched frequency queries: query q matches ``items[q]`` against
        the key table of row ``rows[q]`` -- [N, I] from one table gather."""
        r = rows.long()
        keys, counts = state["keys"][r], state["counts"][r]     # [N, k]
        eq = keys[:, None, :] == items[:, :, None]
        return torch.where(eq, counts[:, None, :], 0.0).sum(dim=-1)

    def frequent_items(self, state, min_count: float):
        keep = (state["counts"] - state["error"]) >= min_count
        return state["keys"], state["counts"], keep

    def merge(self, a, b) -> dict:
        """Mergeable-summaries merge: coalesce matching keys (the first
        equal slot represents them), keep the top k, subtract the
        (k+1)-th largest residual count (Agarwal et al.)."""
        keys = torch.cat([a["keys"], b["keys"]])
        counts = torch.cat([a["counts"], b["counts"]])
        error = torch.cat([a["error"], b["error"]])
        eq = (keys[:, None] == keys[None, :]) & (keys[:, None] != EMPTY)
        first = eq.to(torch.uint8).argmax(dim=1)
        live = (first == torch.arange(keys.shape[0], device=keys.device)) \
            & (keys != EMPTY)
        summed = torch.where(eq, counts[None, :], 0.0).sum(dim=1)
        err = torch.where(eq, error[None, :], 0.0).amax(dim=1)
        counts = torch.where(live, summed, 0.0)
        error = torch.where(live, err, 0.0)
        keys = torch.where(live & (counts > 0), keys, EMPTY)
        order = torch.argsort(-counts, stable=True)
        kth = counts[order[self.k]]
        top = order[:self.k]
        new_counts = torch.clamp(counts[top] - kth, min=0.0)
        kept = new_counts > 0
        return dict(keys=torch.where(kept, keys[top], EMPTY),
                    counts=new_counts,
                    error=torch.where(kept, error[top] + kth, 0.0))

    def memory_bytes(self) -> int:
        return self.k * 12
