"""The hashed-routing linear probe (port of ``repro/kernels/probe.py``).

This module is the plain PyTorch version. On the card the same probe is
the ``__device__`` function ``probe_row`` in ``csrc/probe.cuh``, inlined
into both scatter kernels. Both must stay in lockstep with
``service.routing.slot_hash`` (the host-side insert path).

The table mirror holds keys as uint32 (lo, hi) halves in int32 bit
patterns; every shift here runs on int64 values masked to 32 bits, so it
is a logical shift.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing

ROUTE_GOLDEN = 0x9E3779B9
ROUTE_EMPTY_HI = 0xFFFFFFFF     # hi half of an empty slot; valid ids
                                # < 2**63 have hi <= 2**31-1


def slot0(sid_lo, sid_hi, size: int) -> torch.Tensor:
    """Initial probe slot per stream id (uint32 halves), table size pow2."""
    h = hashing.mix32(hashing.as_u32(sid_lo)
                      ^ hashing.mix32(hashing.as_u32(sid_hi) ^ ROUTE_GOLDEN))
    return h & (size - 1)


def probe_rows(keys_lo: torch.Tensor, keys_hi: torch.Tensor,
               rows: torch.Tensor, sid_lo: torch.Tensor,
               sid_hi: torch.Tensor, *, n_probe: int) -> torch.Tensor:
    """int32 rows for a batch of stream ids by linear probing: ``-1`` for
    unrouted ids, and for ids displaced more than ``n_probe`` slots from
    their start slot (exactly as the reference's bounded loop)."""
    size = keys_lo.shape[0]
    klo = hashing.as_u32(keys_lo)
    khi = hashing.as_u32(keys_hi)
    slo = hashing.as_u32(sid_lo)
    shi = hashing.as_u32(sid_hi)
    slot = slot0(slo, shi, size)
    row = torch.full(slo.shape, -1, dtype=torch.int32, device=slo.device)
    done = torch.zeros(slo.shape, dtype=torch.bool, device=slo.device)
    for _ in range(n_probe):
        k_hi = khi[slot]
        hit = (klo[slot] == slo) & (k_hi == shi)
        empty = k_hi == ROUTE_EMPTY_HI
        row = torch.where(hit & ~done, rows[slot].to(torch.int32), row)
        done = done | hit | empty
        slot = torch.where(done, slot, (slot + 1) & (size - 1))
    return row
