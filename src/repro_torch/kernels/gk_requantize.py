"""GK's stacked requantize (no module counterpart in the JAX package:
there the stack is updated by ``GKQuantiles.add_batch`` under the vmap of
``batched.stacked_update``, and no kernel is written for it).

    every row r in [0, n):  requantized with the tuples with
                            mask & (syn_idx == r), at weight 1
    data-source rows:       with every tuple with mask, routed or not

each against the WHOLE batch, its other tuples as +inf at weight 0, as
the reference's vmap has it (a row with no tuple still moves: its
targets sit on midpoints that rounding decides). ``csrc/gk_requantize.cu``
takes the batch in value order (this module's stable ``torch.sort`` of the
masked tuples' value keys, ``core/gk.sort_key``), groups it by row with
the stable sort of ``csrc/row_sort.cuh``, and gives each row a block: its
state sorted in shared memory, merged with its own tuples, the blocked
scan, the m searches over its virtual m + T entries and the gathers
(``kernels/ref.py::gk_requantize_update`` says why the virtual tail gives
the reference's bytes). A state of more than 4,096 values (eps below
4 / 4,096) does not fit a block's shared memory: then every row takes the
kernel's big-row pass, its state sorted in global scratch. The kernel
takes states of up to MAX_M values.

Two entry points, like every registry kind's: ``gk_requantize_update``
takes each tuple's row; ``gk_probe_requantize_update`` takes the routing
table and the stream ids and probes the rows inside the kernel's key pass
(``csrc/probe.cuh``).

The update is in place on the state's two leaves. On CPU tensors the
wrappers run the plain version (``ref.gk_requantize_update``; the fused
entry probes first with ``probe.probe_rows``). On CUDA tensors they
launch the kernels or raise. ``<wrapper>.launches`` counts calls that
launched them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import gk
from . import build, probe, ref

MAX_M = 1 << 20            # csrc/gk_requantize.cu's kMaxM: eps >= 4 / 2**20

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gk_words": (_I, _I, _I, _P, _P),
    "gk_requantize": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P,
                      _P),
    "gk_probe_requantize": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                            _P, _I, _P, _P, _P, _I, _P, _P),
}


def _lib():
    return build.load("gk_requantize", _SIGNATURES)


def _check_state(values, n, t, vals, mask, source_rows, m):
    """Validate the stack and the batch; returns (rows, source rows as a
    contiguous int64 vector or None)."""
    dev = values.device
    if values.dim() != 2 or values.shape[1] != m:
        raise ValueError(f"values must be [n, {m}], got "
                         f"{tuple(values.shape)}")
    rows = values.shape[0]
    build.check(values, "values", torch.float32, (rows, m), dev)
    build.check(n, "n", torch.float32, (rows,), dev)
    build.check(vals, "vals", torch.float32, (t,), dev)
    build.check(mask, "mask", torch.bool, (t,), dev)
    src = None
    if source_rows is not None:      # int64, as the engine indexes rows
        if source_rows.dim() != 1 or source_rows.device != dev:
            raise ValueError(f"source_rows must be a vector on {dev}")
        src = source_rows.to(torch.int64).contiguous()
    return rows, src


def _prepare(values: torch.Tensor, rows: int, m: int, vals: torch.Tensor,
             mask: torch.Tensor):
    """(scratch, order, masked count): the call's scratch, and the batch's
    positions with the masked tuples first, each part stably by value key
    (ties in batch order), and how many are masked (one int32 on the
    card: the host does not wait for it)."""
    t = vals.shape[0]
    words = ctypes.c_longlong(0)
    most = ctypes.c_int(0)
    build.check_launch(_lib().gk_words(rows, m, t, ctypes.addressof(words),
                                       ctypes.addressof(most)), "gk_words")
    if m > most.value:
        raise ValueError(f"a state of {m} values does not fit the kernel "
                         f"(at most {most.value}: eps >= 4 / {most.value})")
    key = (((~mask).to(torch.int64) << 32)
           | (gk.sort_key(vals).to(torch.int64) + (1 << 31)))
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    nmask = mask.sum(dtype=torch.int32).reshape(1)
    scratch = torch.empty((words.value,), dtype=torch.int32,
                          device=values.device)
    return scratch, order, nmask


def gk_requantize_update(values: torch.Tensor, n: torch.Tensor,
                         syn_idx: torch.Tensor, vals: torch.Tensor,
                         mask: torch.Tensor,
                         source_rows: Optional[torch.Tensor] = None, *,
                         m: int) -> None:
    """GK's stacked update, in place, every row requantized. values [n, m]
    f32; n [n] f32; syn_idx [T] i32 (rows outside [0, n), e.g. -1, take no
    tuple); vals [T] f32; mask [T] bool; source_rows: an index vector of
    data-source rows (rows outside [0, n) are skipped), or None; m: the
    kind's (at most MAX_M)."""
    if values.device.type == "cpu":
        ref.gk_requantize_update(values, n, syn_idx, vals, mask, source_rows,
                                 m=m)
        return
    build.require_cuda(values)
    dev = values.device
    t = syn_idx.shape[0]
    rows, src = _check_state(values, n, t, vals, mask, source_rows, m)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), dev)
    if rows == 0:
        return
    scratch, order, nmask = _prepare(values, rows, m, vals, mask)
    err = _lib().gk_requantize(
        values.data_ptr(), n.data_ptr(), rows, m, syn_idx.data_ptr(),
        vals.data_ptr(), mask.data_ptr(), t, order.data_ptr(),
        nmask.data_ptr(), build.ptr(src), 0 if src is None else src.shape[0],
        scratch.data_ptr(), build.stream(dev))
    build.check_launch(err, "gk_requantize")
    gk_requantize_update.launches += 1


gk_requantize_update.launches = 0


def gk_probe_requantize_update(values: torch.Tensor, n: torch.Tensor,
                               keys_lo: torch.Tensor, keys_hi: torch.Tensor,
                               table_rows: torch.Tensor,
                               sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                               vals: torch.Tensor, mask: torch.Tensor,
                               source_rows: Optional[torch.Tensor] = None,
                               *, n_probe: int, m: int) -> None:
    """Routing probe + GK's stacked update, in place: each tuple's row is
    the routing table's for its stream id (keys_lo / keys_hi / table_rows:
    the table mirror, pow2 size, int32 bit patterns of the uint32 halves;
    sid_lo / sid_hi [T] the ids' halves), -1 for an id not in the table or
    displaced more than ``n_probe`` slots; the rest as
    :func:`gk_requantize_update`. The probe runs in the kernel's key
    pass."""
    if values.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        ref.gk_requantize_update(values, n, rows, vals, mask, source_rows,
                                 m=m)
        return
    build.require_cuda(values)
    dev = values.device
    t = sid_lo.shape[0]
    rows, src = _check_state(values, n, t, vals, mask, source_rows, m)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi, t,
                             dev)
    if rows == 0:
        return
    scratch, order, nmask = _prepare(values, rows, m, vals, mask)
    err = _lib().gk_probe_requantize(
        values.data_ptr(), n.data_ptr(), rows, m, keys_lo.data_ptr(),
        keys_hi.data_ptr(), table_rows.data_ptr(), size, sid_lo.data_ptr(),
        sid_hi.data_ptr(), int(n_probe), vals.data_ptr(), mask.data_ptr(), t,
        order.data_ptr(), nmask.data_ptr(), build.ptr(src),
        0 if src is None else src.shape[0], scratch.data_ptr(),
        build.stream(dev))
    build.check_launch(err, "gk_probe_requantize")
    gk_probe_requantize_update.launches += 1


gk_probe_requantize_update.launches = 0
