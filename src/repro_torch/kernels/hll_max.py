"""HyperLogLog register max-scatter on the bit-set kernel (port of
``repro/kernels/hll_max.py``).

The TPU kernels sweep a one-hot max cube per tile; on Hopper the update
is the k = 1 case of the bit-set kernel (``bitset_or.py``,
``csrc/bitset_or.cu``), exact because integer max does not depend on
order:

    regs[s, bucket[t]] = max(regs[s, bucket[t]], rank[t])   for syn[t] == s

``bucket [T]`` is passed as the ``[T, 1]`` position operand (a view):
the kernel drops rank <= 0, buckets outside ``[0, m)`` and rows outside
``[0, n)``, as the plain version does, and checks the operands (named
as its own: ``bits``, ``idx``, ``upd``). Both entry points update
``regs`` in place and need no padding. On a CPU tensor each wrapper
runs the plain version (``ref.py``, with the probe from ``probe.py``);
on a CUDA tensor it launches the kernel or raises. These wrappers count
their own launches (``<wrapper>.launches``, and
``hll_max_update.one_row_launches`` those on a one-row state), apart
from the Bloom and FM wrappers'.
"""
from __future__ import annotations

import torch

from . import bitset_or, probe, ref


def hll_max_update(regs: torch.Tensor, syn_idx: torch.Tensor,
                   bucket: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """regs [n, m] i32, in place; syn_idx / bucket / rank [T] i32 (rank 0
    is a no-op; rows outside [0, n), e.g. -1, are dropped)."""
    if regs.device.type == "cpu":
        return ref.hll_max_update(regs, syn_idx, bucket, rank)
    if bitset_or.launch(regs, syn_idx, bucket[:, None], rank):
        hll_max_update.launches += 1
        hll_max_update.one_row_launches += regs.shape[0] == 1
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
    if bitset_or.launch_probe(regs, keys_lo, keys_hi, table_rows, sid_lo,
                              sid_hi, bucket[:, None], rank,
                              n_probe=n_probe):
        hll_probe_max_update.launches += 1
    return regs


hll_probe_max_update.launches = 0
