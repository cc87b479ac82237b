"""Sticky Sampling's stacked update (no module counterpart in the JAX
package: there the stack is updated by ``StickySampling.add_batch``, a
``lax.scan``, under the vmap of ``batched.stacked_update``, and no kernel
is written for it).

    every row:          the bump check of the batch's first step
    row r in [0, n):    steps through the tuples with mask & (syn_idx == r)
    data-source rows:   step through every tuple with mask, routed or not
    a walked row:       the check of the step after its last tuple, where
                        that tuple is not the batch's last

each in batch order, with the reference's step. The reference's vmap has
every row step through the whole batch masked to its own tuples
(capacity x T steps), and a masked step still takes the bump check
(``core/sticky.walk_row`` says why these are all the bumps a row takes).
``csrc/sticky_scan.cu`` takes the first checks in a pass over every row,
groups the batch by row with the stable sort of ``csrc/row_sort.cuh``
and walks each row's own tuples once, the table in shared memory: a
routed row's run by one warp, 32 tuples a group placed at once; a
data-source row by a block, its masked tuples spread over its warps.
Between bumps a key changes only where an admitted miss takes the first
empty slot, so the walk keeps each slot's adds as a count and folds
them into the float counts before each bump (byte for byte the plain
version's sequential adds).

The float functions ``want_epoch`` and ``geo`` reach the kernel as
tables of their steps (``core/sticky.py``), built on the CPU from the
literal float32 functions and kept on the card one buffer a (device,
capacity); :func:`eval_tables` evaluates the kernel's own lookups, for
the check that the tables equal the functions.

Two entry points, like every registry kind's: ``sticky_scan_update``
takes each tuple's row; ``sticky_probe_scan_update`` takes the routing
table and the stream ids and probes the rows inside the kernel's key pass
(``csrc/probe.cuh``).

The update is in place on the state's four leaves. On CPU tensors the
wrappers run the plain version (``ref.py``: the first checks, the
grouping by ``torch.sort(stable=True)``, then each row's walk; the fused
entry probes first with ``probe.probe_rows``). On CUDA tensors they
launch the kernels or raise. ``<wrapper>.launches`` counts calls that
launched them, ``<wrapper>.launches_by_capacity[c]`` those on tables of c
slots.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing, sticky
from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_SIGNATURES = {
    "sticky_words": (_I, _I, _P),
    "sticky_layout": (_P, _P),
    "sticky_scan": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _U,
                    _U, _P, _P),
    "sticky_probe_scan": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                          _P, _P, _I, _P, _I, _P, _U, _U, _P, _P),
    "sticky_eval": (_P, _I, _I, _P, _P, _I, _P, _P),
}
_MAX_EPOCHS, _MAX_GEO = 32, 64

# (device, capacity) -> the tables' int32 words on that device
_TABLES: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _lib():
    return build.load("sticky_scan", _SIGNATURES)


def table_words(capacity: int) -> np.ndarray:
    """The kernel's tables for a kind of ``capacity`` slots, as int32
    words: the number of epochs and of geo thresholds, each epoch's first
    count (``sticky.epoch_starts``), the geo thresholds and values
    (``sticky.geo_steps``) and the admission limits (``sticky.inv_rates``),
    each padded to its array in the source's ``Tables``."""
    starts = sticky.epoch_starts(capacity * 16)
    at, vals = sticky.geo_steps()
    rates = sticky.inv_rates()
    if len(starts) > _MAX_EPOCHS or len(at) > _MAX_GEO:
        raise ValueError("the float functions have more steps than the "
                         "kernel's tables hold")
    words = np.zeros(2 + _MAX_EPOCHS + _MAX_GEO + _MAX_GEO + 1 + len(rates),
                     np.int32)
    words[0], words[1] = len(starts), len(at)
    o = 2
    words[o:o + len(starts)] = starts
    o += _MAX_EPOCHS
    words[o:o + len(at)] = np.asarray(at, np.int64).astype(np.uint32).view(
        np.int32)
    o += _MAX_GEO
    words[o:o + len(vals)] = np.asarray(vals, np.float32).view(np.int32)
    o += _MAX_GEO + 1
    words[o:] = np.asarray(rates, np.float32).view(np.int32)
    return words


def _tables(dev: torch.device, capacity: int) -> torch.Tensor:
    key = (dev, capacity)
    buf = _TABLES.get(key)
    if buf is None:
        words = ctypes.c_int(0)
        most = ctypes.c_int(0)
        build.check_launch(_lib().sticky_layout(ctypes.addressof(words),
                                                ctypes.addressof(most)),
                           "sticky_layout")
        host = table_words(capacity)
        if host.size != words.value:
            raise RuntimeError(f"sticky tables: {host.size} words here, "
                               f"{words.value} in the source")
        if capacity > most.value:
            raise ValueError(f"a table of {capacity} slots does not fit a "
                             f"block's shared memory ({most.value} slots)")
        buf = torch.from_numpy(host).to(dev)
        _TABLES[key] = buf
    return buf


def _mix(seed: int) -> int:
    """``hashing.hash_u32``'s seed word: seed * GOLDEN + 1 mod 2**32."""
    return ((int(seed) & hashing.MASK32) * hashing._GOLDEN + 1) \
        & hashing.MASK32


def _check_state(keys, counts, n_seen, epoch, t, items, mask, source_rows,
                 support, eps, delta, seed):
    """Validate the stack and the batch; returns (n, capacity, source rows
    as a contiguous int32 vector or None)."""
    dev = keys.device
    if keys.dim() != 2:
        raise ValueError(f"keys must be [n, capacity], got "
                         f"{tuple(keys.shape)}")
    n, cap = keys.shape
    want = sticky.StickySampling(support, eps, delta, seed).capacity
    if cap != want:
        raise ValueError(f"keys has {cap} slots, the kind {want}")
    build.check(keys, "keys", torch.int32, (n, cap), dev)
    build.check(counts, "counts", torch.float32, (n, cap), dev)
    build.check(n_seen, "n_seen", torch.int32, (n,), dev)
    build.check(epoch, "epoch", torch.int32, (n,), dev)
    build.check(items, "items", torch.int32, (t,), dev)
    build.check(mask, "mask", torch.bool, (t,), dev)
    src = None
    if source_rows is not None:
        if source_rows.dim() != 1 or source_rows.device != dev:
            raise ValueError(f"source_rows must be a vector on {dev}")
        src = source_rows.to(torch.int32).contiguous()
    return n, cap, src


def sticky_scan_update(keys: torch.Tensor, counts: torch.Tensor,
                       n_seen: torch.Tensor, epoch: torch.Tensor,
                       syn_idx: torch.Tensor, items: torch.Tensor,
                       mask: torch.Tensor,
                       source_rows: Optional[torch.Tensor] = None, *,
                       support: float, eps: float, delta: float,
                       seed: int) -> None:
    """Sticky Sampling's stacked update, in place. keys [n, capacity] i32
    (the uint32 identities' bits, -1 empty); counts [n, capacity] f32;
    n_seen, epoch [n] i32; syn_idx [T] i32 (rows outside [0, n), e.g. -1,
    take no tuple); items [T] i32; mask [T] bool; source_rows: an index
    vector of data-source rows (rows outside [0, n) are skipped), or None;
    support, eps, delta, seed: the kind's (capacity must be its)."""
    params = dict(support=support, eps=eps, delta=delta, seed=seed)
    if keys.device.type == "cpu":
        ref.sticky_scan_update(keys, counts, n_seen, epoch, syn_idx, items,
                               mask, source_rows, **params)
        return
    build.require_cuda(keys)
    dev = keys.device
    t = syn_idx.shape[0]
    n, cap, src = _check_state(keys, counts, n_seen, epoch, t, items, mask,
                               source_rows, **params)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), dev)
    if t == 0 or n == 0:
        return
    tables = _tables(dev, cap)
    scratch = _scratch(dev, n, t)
    err = _lib().sticky_scan(
        keys.data_ptr(), counts.data_ptr(), n_seen.data_ptr(),
        epoch.data_ptr(), n, cap, syn_idx.data_ptr(), items.data_ptr(),
        mask.data_ptr(), t, build.ptr(src),
        0 if src is None else src.shape[0], tables.data_ptr(), _mix(seed),
        _mix(seed + 1), scratch.data_ptr(), build.stream(dev))
    build.check_launch(err, "sticky_scan")
    sticky_scan_update.launches += 1
    sticky_scan_update.launches_by_capacity[cap] += 1


sticky_scan_update.launches = 0
sticky_scan_update.launches_by_capacity = collections.Counter()


def sticky_probe_scan_update(keys: torch.Tensor, counts: torch.Tensor,
                             n_seen: torch.Tensor, epoch: torch.Tensor,
                             keys_lo: torch.Tensor, keys_hi: torch.Tensor,
                             table_rows: torch.Tensor, sid_lo: torch.Tensor,
                             sid_hi: torch.Tensor, items: torch.Tensor,
                             mask: torch.Tensor,
                             source_rows: Optional[torch.Tensor] = None, *,
                             n_probe: int, support: float, eps: float,
                             delta: float, seed: int) -> None:
    """Routing probe + Sticky Sampling's stacked update, in place: each
    tuple's row is the routing table's for its stream id (keys_lo /
    keys_hi / table_rows: the table mirror, pow2 size, int32 bit patterns
    of the uint32 halves; sid_lo / sid_hi [T] the ids' halves), -1 for an
    id not in the table or displaced more than ``n_probe`` slots; the rest
    as :func:`sticky_scan_update`. The probe runs in the kernel's key
    pass."""
    params = dict(support=support, eps=eps, delta=delta, seed=seed)
    if keys.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        ref.sticky_scan_update(keys, counts, n_seen, epoch, rows, items,
                               mask, source_rows, **params)
        return
    build.require_cuda(keys)
    dev = keys.device
    t = sid_lo.shape[0]
    n, cap, src = _check_state(keys, counts, n_seen, epoch, t, items, mask,
                               source_rows, **params)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi, t,
                             dev)
    if t == 0 or n == 0:
        return
    tables = _tables(dev, cap)
    scratch = _scratch(dev, n, t)
    err = _lib().sticky_probe_scan(
        keys.data_ptr(), counts.data_ptr(), n_seen.data_ptr(),
        epoch.data_ptr(), n, cap, keys_lo.data_ptr(), keys_hi.data_ptr(),
        table_rows.data_ptr(), size, sid_lo.data_ptr(), sid_hi.data_ptr(),
        int(n_probe), items.data_ptr(), mask.data_ptr(), t, build.ptr(src),
        0 if src is None else src.shape[0], tables.data_ptr(), _mix(seed),
        _mix(seed + 1), scratch.data_ptr(), build.stream(dev))
    build.check_launch(err, "sticky_probe_scan")
    sticky_probe_scan_update.launches += 1
    sticky_probe_scan_update.launches_by_capacity[cap] += 1


sticky_probe_scan_update.launches = 0
sticky_probe_scan_update.launches_by_capacity = collections.Counter()


def _scratch(dev: torch.device, n: int, t: int) -> torch.Tensor:
    words = ctypes.c_longlong(0)
    build.check_launch(_lib().sticky_words(n, t, ctypes.addressof(words)),
                       "sticky_words")
    return torch.empty((words.value,), dtype=torch.int32, device=dev)


def eval_tables(capacity: int, n0: int, count_n: int, h: torch.Tensor):
    """The kernel's own ``want_epoch`` of the counts n0 .. n0 + count_n - 1
    (int32) and ``geo`` of the uint32 hashes ``h`` (an int32 CUDA tensor of
    their bits; float32), through the tables of a kind of ``capacity``
    slots. For checks, not for the path."""
    build.require_cuda(h)
    dev = h.device
    h = h.contiguous()
    want = torch.empty(count_n, dtype=torch.int32, device=dev)
    geo = torch.empty(h.shape[0], dtype=torch.float32, device=dev)
    err = _lib().sticky_eval(_tables(dev, capacity).data_ptr(), n0, count_n,
                             want.data_ptr(), h.data_ptr(), h.shape[0],
                             geo.data_ptr(), build.stream(dev))
    build.check_launch(err, "sticky_eval")
    return want, geo
