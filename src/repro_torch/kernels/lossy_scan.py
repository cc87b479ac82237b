"""Lossy Counting's stacked scan (no module counterpart in the JAX
package: there the stack is updated by ``LossyCounting.add_batch``, a
``lax.scan``, under the vmap of ``batched.stacked_update``, and no kernel
is written for it).

    row r in [0, n):    scans the tuples with mask & (syn_idx == r)
    data-source rows:   scan every tuple with mask, routed or not
    every other row:    untouched

each in batch order, with the reference's one-slot step. The reference's
vmap has every row scan the whole batch masked to its own tuples
(capacity x T steps); ``csrc/lossy_scan.cu`` groups the batch by row with
the stable sort of ``csrc/row_sort.cuh`` and walks each row's own tuples
once, one warp a row, the table in shared memory. A table of up to
``group_k()[0]`` slots (1,024) is walked 32 tuples at a time: the lanes
find their items' slots at once (by comparing with every key up to
``group_k()[1]`` slots, 128, through a hash index above); on a full
table the misses of a prefix take the slots of least count (a bitmask
of them) in slot order all at once, with the prefix's hits on other
slots, each slot's adds in batch order; else the hits before a miss,
then that miss.
Larger tables take one step a tuple; one larger than a block's shared
memory (k above ``max_shared_k()``, 19,370 on an H100) is walked in place
in device memory, not refused.

The update is in place on the state's three leaves; it needs no padding.
On CPU tensors the wrapper runs the plain version (``ref.py``: the
grouping by ``torch.sort(stable=True)``, then the one-row scan per row).
On CUDA tensors it launches the kernels or raises.
``lossy_scan_update.launches`` counts calls that launched them,
``lossy_scan_update.launches_by_k[k]`` those on tables of k slots.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lossy_words": (_I, _I, _P),
    "lossy_max_shared_k": (_P,),
    "lossy_group_k": (_P, _P),
    "lossy_scan": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P),
}


def _lib():
    return build.load("lossy_scan", _SIGNATURES)


def max_shared_k() -> int:
    """The most slots a table may have for a warp to hold it in shared
    memory on the current card; larger tables are walked in device
    memory."""
    k = ctypes.c_int(0)
    build.check_launch(_lib().lossy_max_shared_k(ctypes.addressof(k)),
                       "lossy_max_shared_k")
    return k.value


def group_k() -> tuple:
    """(the most slots a table may have for its walk to take 32 tuples at
    a time, larger tables taking one step a tuple; the most whose lookups
    compare with every key, larger ones going through a hash index)."""
    group, broadcast = ctypes.c_int(0), ctypes.c_int(0)
    build.check_launch(_lib().lossy_group_k(ctypes.addressof(group),
                                            ctypes.addressof(broadcast)),
                       "lossy_group_k")
    return group.value, broadcast.value


def walks_of(syn_idx: torch.Tensor, mask: torch.Tensor, n: int,
             source_rows: Optional[torch.Tensor] = None) -> tuple:
    """(walks, longest walk) of a batch on a stack of ``n`` rows: the rows
    the kernel walks (each routed row with a masked-in tuple, each distinct
    data-source row), and the most steps one of them takes, which form one
    dependent chain (a data-source row's: every masked-in tuple).
    Synchronises; for checks, not for the path."""
    src = set()
    if source_rows is not None:
        src = {int(r) for r in source_rows.tolist() if 0 <= r < n}
    keep = mask & (syn_idx >= 0) & (syn_idx < n)
    rows = syn_idx[keep].long()
    counts = torch.bincount(rows, minlength=n) if rows.numel() else \
        torch.zeros(n, dtype=torch.long, device=syn_idx.device)
    if src:
        counts[sorted(src)] = 0
    routed = int((counts > 0).sum())
    longest = int(counts.max()) if n else 0
    if src:
        longest = max(longest, int(mask.sum()))
    return routed + len(src), longest


def lossy_scan_update(keys: torch.Tensor, counts: torch.Tensor,
                      error: torch.Tensor, syn_idx: torch.Tensor,
                      items: torch.Tensor, values: torch.Tensor,
                      mask: torch.Tensor,
                      source_rows: Optional[torch.Tensor] = None) -> None:
    """Lossy Counting's stacked scan, in place. keys [n, k] i32 (the
    uint32 identities' bits, -1 empty); counts, error [n, k] f32;
    syn_idx [T] i32 (rows outside [0, n), e.g. -1, are dropped); items
    [T] i32; values [T] f32; mask [T] bool; source_rows: an index vector
    of data-source rows (rows outside [0, n) are skipped), or None."""
    if keys.device.type == "cpu":
        ref.lossy_scan_update(keys, counts, error, syn_idx, items, values,
                              mask, source_rows)
        return
    build.require_cuda(keys)
    dev = keys.device
    if keys.dim() != 2:
        raise ValueError(f"keys must be [n, k], got {tuple(keys.shape)}")
    n, k = keys.shape
    t = syn_idx.shape[0]
    build.check(keys, "keys", torch.int32, (n, k), dev)
    build.check(counts, "counts", torch.float32, (n, k), dev)
    build.check(error, "error", torch.float32, (n, k), dev)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), dev)
    build.check(items, "items", torch.int32, (t,), dev)
    build.check(values, "values", torch.float32, (t,), dev)
    build.check(mask, "mask", torch.bool, (t,), dev)
    src = None
    if source_rows is not None:
        if source_rows.dim() != 1 or source_rows.device != dev:
            raise ValueError(f"source_rows must be a vector on {dev}")
        src = source_rows.to(torch.int32).contiguous()
    if t == 0 or n == 0 or k == 0:
        return
    words = ctypes.c_longlong(0)
    build.check_launch(_lib().lossy_words(n, t, ctypes.addressof(words)),
                       "lossy_words")
    scratch = torch.empty((words.value,), dtype=torch.int32, device=dev)
    err = _lib().lossy_scan(
        keys.data_ptr(), counts.data_ptr(), error.data_ptr(), n, k,
        syn_idx.data_ptr(), items.data_ptr(), values.data_ptr(),
        mask.data_ptr(), t, build.ptr(src),
        0 if src is None else src.shape[0], scratch.data_ptr(),
        build.stream(dev))
    build.check_launch(err, "lossy_scan")
    lossy_scan_update.launches += 1
    lossy_scan_update.launches_by_k[k] += 1


lossy_scan_update.launches = 0
lossy_scan_update.launches_by_k = collections.Counter()
