"""CountMin / count-sketch scatter-add (port of
``repro/kernels/onehot_matmul.py``).

The file keeps the reference's name so a reader finds its counterpart,
but the kernel is NOT a one-hot matmul: the TPU form exists because TPUs
hate scatter, and on Hopper the same update is a direct, deterministic
scatter written by hand in ``csrc/countmin_scatter.cu``:

    counts[s, j, idx[t, j]] += values[t] * signs[t, j]   for syn[t] == s

On the main path (d * n >= 1024) the source groups the batch by row
with a stable counting sort of its own (``csrc/row_sort.cuh``), gathers
each sorted tuple's buckets and weights into sorted order (recording
each run's end), then one warp per (32 sorted positions, depth row) adds
the runs that start there, each element by one thread in batch order.
Smaller stacks (the data-source fresh sketch, n = 1) key each (tuple,
depth row) entry by the element it adds to and run the same sort, gather
and walk over those keys: every run is then one element, summed by one
thread in batch order. The wrapper allocates the scratch
(``cm_layout``); no launch allocates or waits.

Both entry points update ``counts`` in place (the reference aliases the
state operand to its output, ``input_output_aliases={0: 0}``) and need no
padding: the kernels mask their own ragged edge.

On a CPU tensor each wrapper runs the plain version (``ref.py``, with the
probe from ``probe.py``). On a CUDA tensor it launches the kernels or
raises. ``<wrapper>.launches`` counts calls that launched them,
``<wrapper>.signed_launches`` those given signs (AMS),
``onehot_scatter_add.one_row_launches`` those on a one-row state, and
``onehot_scatter_add.signed_one_row_launches`` those both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cm_layout": (_I, _I, _I, _I, _P),
    "cm_scatter": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P),
    "cm_probe_scatter": (_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                         _P, _P, _P, _I, _P, _P),
    "cm_sort_rows": (_P, _I, _I, _P, _P),
}


def _lib():
    return build.load("countmin_scatter", _SIGNATURES)


def _scratch(n: int, d: int, w: int, t: int, device: torch.device):
    """The scratch of a call (int32 words, laid out by the source; d = 0:
    the sort's alone) and the word offsets of the sort's count, keys and
    entry indices."""
    off = (ctypes.c_longlong * 4)()
    build.check_launch(_lib().cm_layout(n, d, w, t, ctypes.addressof(off)),
                       "cm_layout")
    scratch = torch.empty((off[3],), dtype=torch.int32, device=device)
    return scratch, tuple(off[:3])


def runs_of(rows: torch.Tensor, n: int) -> tuple:
    """(runs, longest run) of a batch's routed rows ``rows`` [T] on a stack
    of ``n`` rows: the rows the walk visits, and the tuples of the hottest
    one, whose adds at one depth row form the longest add chain where they
    share a bucket (a stream's tuples do). Synchronises; for checks, not
    for the path."""
    kept = rows[(rows >= 0) & (rows < n)].long()
    if kept.numel() == 0:
        return 0, 0
    counts = torch.bincount(kept, minlength=n)
    return int((counts > 0).sum()), int(counts.max())


def element_runs_of(rows: torch.Tensor, idx: torch.Tensor,
                    values: torch.Tensor, n: int, w: int,
                    signs: Optional[torch.Tensor] = None) -> tuple:
    """(elements, longest run) of a batch on a small stack (d * n < 1024)
    of ``n`` rows and width ``w``: the elements it adds to, which are the
    runs of the element-keyed walk, and the most entries at one element,
    whose adds form the longest add chain. Entries that add nothing (rows
    outside [0, n), buckets outside [0, w), zero weights) are left out, as
    the kernels leave them out. Synchronises; for checks, not for the
    path."""
    d = idx.shape[1]
    x = values[:, None] if signs is None else values[:, None] * signs
    r, b = rows.long()[:, None], idx.long()
    adds = (x != 0) & (r >= 0) & (r < n) & (b >= 0) & (b < w)
    key = ((r * d + torch.arange(d, device=idx.device)) * w + b)[adds]
    if key.numel() == 0:
        return 0, 0
    counts = torch.unique(key, return_counts=True)[1]
    return int(counts.numel()), int(counts.max())


def sort_rows(rows: torch.Tensor, n: int) -> tuple:
    """The kernels' stable row sort alone, on the card: (srow, perm) of the
    tuples whose row lies in [0, n), ordered by row and then by batch
    index (``torch.sort(stable=True)`` of those rows and their indices).
    Synchronises; for tests, not for the path."""
    build.require_cuda(rows)
    t = rows.shape[0]
    build.check(rows, "rows", torch.int32, (t,), rows.device)
    if t == 0 or n <= 0:
        return rows[:0], rows[:0]
    scratch, (c, r, p) = _scratch(n, 0, 1, t, rows.device)
    err = _lib().cm_sort_rows(rows.data_ptr(), n, t, scratch.data_ptr(),
                              build.stream(rows.device))
    build.check_launch(err, "cm_sort_rows")
    k = int(scratch[c])
    return scratch[r:r + k], scratch[p:p + k]


def _check_batch(counts, idx, values, signs, t):
    dev = counts.device
    n, d, w = counts.shape
    build.check(counts, "counts", torch.float32, (n, d, w), dev)
    build.check(idx, "idx", torch.int32, (t, d), dev)
    build.check(values, "values", torch.float32, (t,), dev)
    if signs is not None:
        build.check(signs, "signs", torch.float32, (t, d), dev)


def onehot_scatter_add(counts: torch.Tensor, syn_idx: torch.Tensor,
                       idx: torch.Tensor, values: torch.Tensor,
                       signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """counts [n, d, w] f32 += scatter of T updates, in place.
    syn_idx [T] i32 (rows outside [0, n), e.g. -1, are dropped);
    idx [T, d] i32; values [T] f32 (mask folded in); signs [T, d] f32, or
    None for +1 (CountMin)."""
    if counts.device.type == "cpu":
        return ref.onehot_scatter_add(counts, syn_idx, idx, values, signs)
    build.require_cuda(counts)
    t = syn_idx.shape[0]
    _check_batch(counts, idx, values, signs, t)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), counts.device)
    if t == 0:
        return counts
    n, d, w = counts.shape
    scratch, _ = _scratch(n, d, w, t, counts.device)
    err = _lib().cm_scatter(
        counts.data_ptr(), n, d, w, syn_idx.data_ptr(), idx.data_ptr(),
        values.data_ptr(), build.ptr(signs), t, scratch.data_ptr(),
        build.stream(counts.device))
    build.check_launch(err, "cm_scatter")
    onehot_scatter_add.launches += 1
    onehot_scatter_add.one_row_launches += n == 1
    onehot_scatter_add.signed_launches += signs is not None
    onehot_scatter_add.signed_one_row_launches += (
        n == 1 and signs is not None)
    return counts


onehot_scatter_add.launches = 0
# of those, launches on a one-row state: the data-source fresh sketch
onehot_scatter_add.one_row_launches = 0
# launches given signs: AMS's
onehot_scatter_add.signed_launches = 0
# and launches both: AMS's data-source folds
onehot_scatter_add.signed_one_row_launches = 0


def onehot_probe_scatter(counts: torch.Tensor, keys_lo: torch.Tensor,
                         keys_hi: torch.Tensor, table_rows: torch.Tensor,
                         sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                         idx: torch.Tensor, values: torch.Tensor,
                         signs: Optional[torch.Tensor] = None, *,
                         n_probe: int) -> torch.Tensor:
    """Routing probe + scatter-add, in place. keys_lo / keys_hi /
    table_rows: the routing-table mirror (pow2 size, int32 bit patterns of
    the uint32 halves); sid_lo / sid_hi [T] int32 bit patterns of the
    stream ids' halves; the rest as :func:`onehot_scatter_add`."""
    if counts.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        return ref.onehot_scatter_add(counts, rows, idx, values, signs)
    build.require_cuda(counts)
    t = sid_lo.shape[0]
    _check_batch(counts, idx, values, signs, t)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                             t, counts.device)
    if t == 0:
        return counts
    n, d, w = counts.shape
    rows = torch.empty((t,), dtype=torch.int32, device=counts.device)
    scratch, _ = _scratch(n, d, w, t, counts.device)
    err = _lib().cm_probe_scatter(
        counts.data_ptr(), n, d, w, keys_lo.data_ptr(), keys_hi.data_ptr(),
        table_rows.data_ptr(), size, sid_lo.data_ptr(), sid_hi.data_ptr(),
        int(n_probe), rows.data_ptr(), idx.data_ptr(), values.data_ptr(),
        build.ptr(signs), t, scratch.data_ptr(), build.stream(counts.device))
    build.check_launch(err, "cm_probe_scatter")
    onehot_probe_scatter.launches += 1
    onehot_probe_scatter.signed_launches += signs is not None
    return counts


onehot_probe_scatter.launches = 0
onehot_probe_scatter.signed_launches = 0
