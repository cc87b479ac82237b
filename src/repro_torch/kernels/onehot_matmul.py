"""CountMin / count-sketch scatter-add (port of
``repro/kernels/onehot_matmul.py``).

The file keeps the reference's name so a reader finds its counterpart,
but the kernel is NOT a one-hot matmul: the TPU form exists because TPUs
hate scatter, and on Hopper the same update is a direct, deterministic
scatter written by hand in ``csrc/countmin_scatter.cu``:

    counts[s, j, idx[t, j]] += values[t] * signs[t, j]   for syn[t] == s

Both entry points update ``counts`` in place (the reference aliases the
state operand to its output, ``input_output_aliases={0: 0}``) and need no
padding: the kernel masks its own ragged edge.

On a CPU tensor each wrapper runs the plain version (``ref.py``, with the
probe from ``probe.py``). On a CUDA tensor it launches the kernel or
raises. ``<wrapper>.launches`` counts kernel launches, and
``onehot_scatter_add.one_row_launches`` those on a one-row state.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cm_scatter": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    "cm_probe_scatter": (_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                         _P, _P, _P, _I, _P),
}


def _lib():
    return build.load("countmin_scatter", _SIGNATURES)


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
    err = _lib().cm_scatter(
        counts.data_ptr(), n, d, w, syn_idx.data_ptr(), idx.data_ptr(),
        values.data_ptr(), build.ptr(signs), t, build.stream(counts.device))
    build.check_launch(err, "cm_scatter")
    onehot_scatter_add.launches += 1
    onehot_scatter_add.one_row_launches += n == 1
    return counts


onehot_scatter_add.launches = 0
# of those, launches on a one-row state: the data-source fresh sketch
onehot_scatter_add.one_row_launches = 0


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
    scratch = torch.empty((t,), dtype=torch.int32, device=counts.device)
    err = _lib().cm_probe_scatter(
        counts.data_ptr(), n, d, w, keys_lo.data_ptr(), keys_hi.data_ptr(),
        table_rows.data_ptr(), size, sid_lo.data_ptr(), sid_hi.data_ptr(),
        int(n_probe), scratch.data_ptr(), idx.data_ptr(), values.data_ptr(),
        build.ptr(signs), t, build.stream(counts.device))
    build.check_launch(err, "cm_probe_scatter")
    onehot_probe_scatter.launches += 1
    return counts


onehot_probe_scatter.launches = 0
