"""The reservoir sampler's stacked update (no module counterpart in the JAX
package: there the stack is updated by ``ReservoirSampler.add_batch``, a
``lax.scan``, under the vmap of ``batched.stacked_update``, and no kernel
is written for it).

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
for byte. The whole update is one cooperative launch whose phases are
separated by grid-wide barriers.

Two entry points, like every registry kind's: ``reservoir_scan_update``
takes each tuple's row; ``reservoir_probe_scan_update`` takes the
routing table and the stream ids and probes the rows inside the kernel's
first phase (``csrc/probe.cuh``).

The update is in place on the state's three leaves. On CPU tensors the
wrappers run the plain version (``ref.py``: the grouping by
``torch.sort(stable=True)``, then the one-row sampler per row; the fused
entry probes first with ``probe.probe_rows``). On CUDA tensors they
launch the kernel or raise. ``<wrapper>.launches`` counts calls that
launched it.

The kernel accumulates into words of its scratch that must be zero when
it starts, and leaves them zero when it ends. So the scratch is kept
across calls, one buffer a (device, stream, sizes (n, S, T, source
rows)), for the ``_HELD`` sizes a stream used last: an engine that
updates stacks of several sizes in every batch keeps one buffer for
each, and a call at sizes held makes no device activity but the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_SIGNATURES = {
    "reservoir_words": (_I, _I, _I, _I, _P),
    "reservoir_scan": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _U,
                       _P, _P),
    "reservoir_probe_scan": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                             _P, _P, _P, _I, _P, _I, _U, _P, _P),
}

# (device, stream) -> {the sizes it was laid out for: its zeroed words},
# the one used last at the end
_SCRATCH: Dict[Tuple[torch.device, int], Dict[tuple, torch.Tensor]] = {}
_HELD = 8


def _lib():
    return build.load("reservoir_scan", _SIGNATURES)


def _check_state(values, items, n_seen, t, in_items, in_values, mask,
                 source_rows):
    """Validate the stack and the batch; returns (n, S, source rows as a
    contiguous int64 vector or None)."""
    dev = values.device
    if values.dim() != 2:
        raise ValueError(f"values must be [n, S], got {tuple(values.shape)}")
    n, s = values.shape
    build.check(values, "values", torch.float32, (n, s), dev)
    build.check(items, "items", torch.int32, (n, s), dev)
    build.check(n_seen, "n_seen", torch.int32, (n,), dev)
    build.check(in_items, "in_items", torch.int32, (t,), dev)
    build.check(in_values, "in_values", torch.float32, (t,), dev)
    build.check(mask, "mask", torch.bool, (t,), dev)
    src = None
    if source_rows is not None:      # int64, as the engine indexes rows
        if source_rows.dim() != 1 or source_rows.device != dev:
            raise ValueError(f"source_rows must be a vector on {dev}")
        src = source_rows.to(torch.int64).contiguous()
    return n, s, src


def _scratch(dev: torch.device, n: int, s: int, t: int, n_src: int) -> int:
    """The data pointer of this stream's scratch for these sizes, zeroed
    when it is (re)allocated; the kernel leaves the words it needs zero."""
    held = _SCRATCH.setdefault((dev, build.stream(dev)), {})
    sizes = (n, s, t, n_src)
    buf = held.pop(sizes, None)
    if buf is None:
        words = ctypes.c_longlong(0)
        build.check_launch(_lib().reservoir_words(n, s, t, n_src,
                                                  ctypes.addressof(words)),
                           "reservoir_words")
        while len(held) >= _HELD:
            held.pop(next(iter(held)))
        buf = torch.zeros((words.value,), dtype=torch.int32, device=dev)
    held[sizes] = buf
    return buf.data_ptr()


def _launched(err: int, what: str, dev: torch.device) -> None:
    """Raise on a launch error, dropping the stream's scratch, whose zero
    words a failed call may have left set."""
    if err != 0:
        _SCRATCH.pop((dev, build.stream(dev)), None)
    build.check_launch(err, what)


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
    t = syn_idx.shape[0]
    n, s, src = _check_state(values, items, n_seen, t, in_items, in_values,
                             mask, source_rows)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), dev)
    if t == 0 or n == 0 or s == 0:
        return
    n_src = 0 if src is None else src.shape[0]
    err = _lib().reservoir_scan(
        values.data_ptr(), items.data_ptr(), n_seen.data_ptr(), n, s,
        syn_idx.data_ptr(), in_items.data_ptr(), in_values.data_ptr(),
        mask.data_ptr(), t, build.ptr(src), n_src, seed & 0xFFFFFFFF,
        _scratch(dev, n, s, t, n_src), build.stream(dev))
    _launched(err, "reservoir_scan", dev)
    reservoir_scan_update.launches += 1


reservoir_scan_update.launches = 0


def reservoir_probe_scan_update(values: torch.Tensor, items: torch.Tensor,
                                n_seen: torch.Tensor, keys_lo: torch.Tensor,
                                keys_hi: torch.Tensor,
                                table_rows: torch.Tensor,
                                sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                                in_items: torch.Tensor,
                                in_values: torch.Tensor, mask: torch.Tensor,
                                source_rows: Optional[torch.Tensor] = None,
                                *, n_probe: int, seed: int) -> None:
    """Routing probe + the reservoir sampler's stacked update, in place:
    each tuple's row is the routing table's for its stream id (keys_lo /
    keys_hi / table_rows: the table mirror, pow2 size, int32 bit patterns
    of the uint32 halves; sid_lo / sid_hi [T] the ids' halves), -1 for an
    id not in the table or displaced more than ``n_probe`` slots; the rest
    as :func:`reservoir_scan_update`. The probe runs in the kernel's first
    phase."""
    if values.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        ref.reservoir_scan_update(values, items, n_seen, rows, in_items,
                                  in_values, mask, source_rows, seed=seed)
        return
    build.require_cuda(values)
    dev = values.device
    t = sid_lo.shape[0]
    n, s, src = _check_state(values, items, n_seen, t, in_items, in_values,
                             mask, source_rows)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi, t,
                             dev)
    if t == 0 or n == 0 or s == 0:
        return
    n_src = 0 if src is None else src.shape[0]
    err = _lib().reservoir_probe_scan(
        values.data_ptr(), items.data_ptr(), n_seen.data_ptr(), n, s,
        keys_lo.data_ptr(), keys_hi.data_ptr(), table_rows.data_ptr(), size,
        sid_lo.data_ptr(), sid_hi.data_ptr(), int(n_probe),
        in_items.data_ptr(), in_values.data_ptr(), mask.data_ptr(), t,
        build.ptr(src), n_src, seed & 0xFFFFFFFF,
        _scratch(dev, n, s, t, n_src), build.stream(dev))
    _launched(err, "reservoir_probe_scan", dev)
    reservoir_probe_scan_update.launches += 1


reservoir_probe_scan_update.launches = 0
