"""HyperLogLog register max-scatter (port of ``repro/kernels/hll_max.py``).

The TPU kernels sweep a one-hot max cube per tile; on Hopper the update
is a direct ``atomicMax`` scatter written by hand in ``csrc/hll_max.cu``
(exact: integer max does not depend on order):

    regs[s, bucket[t]] = max(regs[s, bucket[t]], rank[t])   for syn[t] == s

Both entry points update ``regs`` in place and need no padding. On a CPU
tensor each wrapper runs the plain version (``ref.py``, with the probe
from ``probe.py``); on a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches, and
``hll_max_update.one_row_launches`` those on a one-row state.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, probe, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "hll_max_update": (_P, _I, _I, _P, _P, _P, _I, _P),
    "hll_probe_max_update": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                             _P, _I, _P),
}


def _lib():
    return build.load("hll_max", _SIGNATURES)


def _check_batch(regs, bucket, rank, t):
    dev = regs.device
    build.check(regs, "regs", torch.int32, tuple(regs.shape), dev)
    if regs.dim() != 2:
        raise ValueError(f"regs must be [n, m], got {tuple(regs.shape)}")
    build.check(bucket, "bucket", torch.int32, (t,), dev)
    build.check(rank, "rank", torch.int32, (t,), dev)


def hll_max_update(regs: torch.Tensor, syn_idx: torch.Tensor,
                   bucket: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """regs [n, m] i32, in place; syn_idx / bucket / rank [T] i32 (rank 0
    is a no-op; rows outside [0, n), e.g. -1, are dropped)."""
    if regs.device.type == "cpu":
        return ref.hll_max_update(regs, syn_idx, bucket, rank)
    build.require_cuda(regs)
    t = syn_idx.shape[0]
    _check_batch(regs, bucket, rank, t)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), regs.device)
    if t == 0:
        return regs
    n, m = regs.shape
    err = _lib().hll_max_update(
        regs.data_ptr(), n, m, syn_idx.data_ptr(), bucket.data_ptr(),
        rank.data_ptr(), t, build.stream(regs.device))
    build.check_launch(err, "hll_max_update")
    hll_max_update.launches += 1
    hll_max_update.one_row_launches += n == 1
    return regs


hll_max_update.launches = 0
# of those, launches on a one-row state: the data-source fresh sketch
hll_max_update.one_row_launches = 0


def hll_probe_max_update(regs: torch.Tensor, keys_lo: torch.Tensor,
                         keys_hi: torch.Tensor, table_rows: torch.Tensor,
                         sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                         bucket: torch.Tensor, rank: torch.Tensor, *,
                         n_probe: int) -> torch.Tensor:
    """Routing probe + register max-scatter in one kernel, in place; the
    table operands as ``onehot_matmul.onehot_probe_scatter``."""
    if regs.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        return ref.hll_max_update(regs, rows, bucket, rank)
    build.require_cuda(regs)
    t = sid_lo.shape[0]
    _check_batch(regs, bucket, rank, t)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                             t, regs.device)
    if t == 0:
        return regs
    n, m = regs.shape
    err = _lib().hll_probe_max_update(
        regs.data_ptr(), n, m, keys_lo.data_ptr(), keys_hi.data_ptr(),
        table_rows.data_ptr(), size, sid_lo.data_ptr(), sid_hi.data_ptr(),
        int(n_probe), bucket.data_ptr(), rank.data_ptr(), t,
        build.stream(regs.device))
    build.check_launch(err, "hll_probe_max_update")
    hll_probe_max_update.launches += 1
    return regs


hll_probe_max_update.launches = 0
