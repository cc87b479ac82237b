"""Stacked bit-set max-scatter into ``[n, m]`` int32 0/1 lanes (port of
``repro/kernels/bitset_or.py``).

Serves Bloom filters (k hash positions per tuple) here and FM/PCSA
bitmaps through ``fm_bitmap.py`` (k = 1). The TPU kernels sweep a
one-hot max cube per tile; on Hopper the update is a direct
``atomicMax`` scatter written by hand in ``csrc/bitset_or.cu`` (exact:
integer max does not depend on order):

    bits[s, idx[t, h]] = max(bits[s, idx[t, h]], upd[t])   for syn[t] == s

Both entry points update ``bits`` in place and need no padding. On a CPU
tensor each wrapper runs the plain version (``ref.py``, with the probe
from ``probe.py``); on a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches (``.one_row_launches``
those on a one-row state); ``fm_bitmap.py`` launches through
:func:`launch` and :func:`launch_probe`, which count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bitset_max_update": (_P, _I, _I, _P, _P, _I, _P, _I, _P),
    "bitset_probe_max_update": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                                _I, _P, _I, _P),
}


def _lib():
    return build.load("bitset_or", _SIGNATURES)


def _check_batch(bits, idx, upd, t):
    dev = bits.device
    if bits.dim() != 2:
        raise ValueError(f"bits must be [n, m], got {tuple(bits.shape)}")
    build.check(bits, "bits", torch.int32, tuple(bits.shape), dev)
    if idx.dim() != 2:
        raise ValueError(f"idx must be [T, k], got {tuple(idx.shape)}")
    build.check(idx, "idx", torch.int32, (t, idx.shape[1]), dev)
    build.check(upd, "upd", torch.int32, (t,), dev)


def launch(bits: torch.Tensor, syn_idx: torch.Tensor, idx: torch.Tensor,
           upd: torch.Tensor) -> bool:
    """Check the operands and launch the rows-given kernel on CUDA
    tensors; True when a kernel was launched (False for an empty batch)."""
    build.require_cuda(bits)
    t = syn_idx.shape[0]
    _check_batch(bits, idx, upd, t)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), bits.device)
    if t == 0 or idx.shape[1] == 0:
        return False
    n, m = bits.shape
    err = _lib().bitset_max_update(
        bits.data_ptr(), n, m, syn_idx.data_ptr(), idx.data_ptr(),
        idx.shape[1], upd.data_ptr(), t, build.stream(bits.device))
    build.check_launch(err, "bitset_max_update")
    return True


def launch_probe(bits: torch.Tensor, keys_lo: torch.Tensor,
                 keys_hi: torch.Tensor, table_rows: torch.Tensor,
                 sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                 idx: torch.Tensor, upd: torch.Tensor, *,
                 n_probe: int) -> bool:
    """As :func:`launch`, for the fused-probe kernel."""
    build.require_cuda(bits)
    t = sid_lo.shape[0]
    _check_batch(bits, idx, upd, t)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                             t, bits.device)
    if t == 0 or idx.shape[1] == 0:
        return False
    n, m = bits.shape
    err = _lib().bitset_probe_max_update(
        bits.data_ptr(), n, m, keys_lo.data_ptr(), keys_hi.data_ptr(),
        table_rows.data_ptr(), size, sid_lo.data_ptr(), sid_hi.data_ptr(),
        int(n_probe), idx.data_ptr(), idx.shape[1], upd.data_ptr(), t,
        build.stream(bits.device))
    build.check_launch(err, "bitset_probe_max_update")
    return True


def bitset_max_update(bits: torch.Tensor, syn_idx: torch.Tensor,
                      idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """bits [n, m] i32, in place; syn_idx [T] i32 (rows outside [0, n),
    e.g. -1, are dropped); idx [T, k] i32 (positions outside [0, m) are
    dropped); upd [T] i32 (upd <= 0 is a no-op)."""
    if bits.device.type == "cpu":
        return ref.bitset_max_update(bits, syn_idx, idx, upd)
    if launch(bits, syn_idx, idx, upd):
        bitset_max_update.launches += 1
        bitset_max_update.one_row_launches += bits.shape[0] == 1
    return bits


bitset_max_update.launches = 0
# of those, launches on a one-row state: the data-source fresh sketch
bitset_max_update.one_row_launches = 0


def bitset_probe_max_update(bits: torch.Tensor, keys_lo: torch.Tensor,
                            keys_hi: torch.Tensor, table_rows: torch.Tensor,
                            sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                            idx: torch.Tensor, upd: torch.Tensor, *,
                            n_probe: int) -> torch.Tensor:
    """Routing probe + bit-set max-scatter in one kernel, in place; the
    table operands as ``onehot_matmul.onehot_probe_scatter``."""
    if bits.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        return ref.bitset_max_update(bits, rows, idx, upd)
    if launch_probe(bits, keys_lo, keys_hi, table_rows, sid_lo, sid_hi, idx,
                    upd, n_probe=n_probe):
        bitset_probe_max_update.launches += 1
    return bits


bitset_probe_max_update.launches = 0
