"""The reservoir sampler's stacked update (no module counterpart in the
JAX package: there the stack is updated by ``ReservoirSampler.add_batch``,
a ``lax.scan``, under the vmap of ``batched.stacked_update``, and no
kernel is written for it).

    row r in [0, n):    takes the tuples with mask & (syn_idx == r)
    data-source rows:   take every tuple with mask, routed or not
    every other row:    untouched

each in batch order, with the reference's step. Unlike Lossy Counting's,
that step reads no state but the count: a row's tuple of rank i (the
row's valid tuples before it) arrives at ``n_seen + i``, and its slot and
whether it writes follow from that count, its item and the seed. So
``csrc/reservoir_scan.cu`` walks no row tuple by tuple: it groups the
batch by row with the stable sort of ``csrc/row_sort.cuh`` (a routed
tuple's rank is its sorted position less its run's start; a data-source
row's is the prefix count of the mask), computes every tuple's slot at
once, and keeps each slot's last writer (the largest rank that writes
it): within a warp's 32 sorted positions by one ``__match_any_sync``, and
across warps, for runs longer than that and for data-source rows, by an
integer ``atomicMax`` of (rank, tuple) per (walk, slot). Both are
independent of scheduling, so the state equals the plain version byte
for byte.

The update is in place on the state's three leaves. On CPU tensors the
wrapper runs the plain version (``ref.py``: the grouping by
``torch.sort(stable=True)``, then the one-row sampler per row). On CUDA
tensors it launches the kernels or raises. ``reservoir_scan_update.
launches`` counts calls that launched them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "reservoir_words": (_I, _I, _I, _I, _P),
    "reservoir_scan": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I,
                       ctypes.c_uint32, _P, _P),
}


def _lib():
    return build.load("reservoir_scan", _SIGNATURES)


def reservoir_scan_update(values: torch.Tensor, items: torch.Tensor,
                          n_seen: torch.Tensor, syn_idx: torch.Tensor,
                          in_items: torch.Tensor, in_values: torch.Tensor,
                          mask: torch.Tensor,
                          source_rows: Optional[torch.Tensor] = None, *,
                          seed: int) -> None:
    """The reservoir sampler's stacked update, in place. values [n, S]
    f32; items [n, S] i32 (the uint32 identities' bits); n_seen [n] i32
    (each row's count plus its tuples of the batch below 2**31); syn_idx
    [T] i32 (rows outside [0, n), e.g. -1, are dropped); in_items [T] i32;
    in_values [T] f32; mask [T] bool; source_rows: an index vector of
    data-source rows (rows outside [0, n) are skipped), or None; seed:
    the kind's."""
    if values.device.type == "cpu":
        ref.reservoir_scan_update(values, items, n_seen, syn_idx, in_items,
                                  in_values, mask, source_rows, seed=seed)
        return
    build.require_cuda(values)
    dev = values.device
    if values.dim() != 2:
        raise ValueError(f"values must be [n, S], got {tuple(values.shape)}")
    n, s = values.shape
    t = syn_idx.shape[0]
    build.check(values, "values", torch.float32, (n, s), dev)
    build.check(items, "items", torch.int32, (n, s), dev)
    build.check(n_seen, "n_seen", torch.int32, (n,), dev)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), dev)
    build.check(in_items, "in_items", torch.int32, (t,), dev)
    build.check(in_values, "in_values", torch.float32, (t,), dev)
    build.check(mask, "mask", torch.bool, (t,), dev)
    src = None
    if source_rows is not None:      # int64, as the engine indexes rows
        if source_rows.dim() != 1 or source_rows.device != dev:
            raise ValueError(f"source_rows must be a vector on {dev}")
        src = source_rows.to(torch.int64).contiguous()
    if t == 0 or n == 0 or s == 0:
        return
    n_src = 0 if src is None else src.shape[0]
    words = ctypes.c_longlong(0)
    build.check_launch(_lib().reservoir_words(n, s, t, n_src,
                                              ctypes.addressof(words)),
                       "reservoir_words")
    scratch = torch.empty((words.value,), dtype=torch.int32, device=dev)
    err = _lib().reservoir_scan(
        values.data_ptr(), items.data_ptr(), n_seen.data_ptr(), n, s,
        syn_idx.data_ptr(), in_items.data_ptr(), in_values.data_ptr(),
        mask.data_ptr(), t, build.ptr(src), n_src, seed & 0xFFFFFFFF,
        scratch.data_ptr(), build.stream(dev))
    build.check_launch(err, "reservoir_scan")
    reservoir_scan_update.launches += 1


reservoir_scan_update.launches = 0
