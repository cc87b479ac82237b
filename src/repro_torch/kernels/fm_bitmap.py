"""FM/PCSA bitmap update on the bit-set kernel (port of
``repro/kernels/fm_bitmap.py``).

An FM sketch stack is ``[n, maps, bits]`` int32 0/1 lanes; each tuple
sets ONE lane, ``pos`` of bitmap ``which``. On the row-major flat plane
``[n, maps * bits]`` that is the k = 1 case of the bit-set kernel
(``bitset_or.py``, ``csrc/bitset_or.cu``):

    flat_pos = which * bits + pos
    flat[syn, flat_pos] = max(flat[syn, flat_pos], upd)

The flat plane is a VIEW of the state, so the kernel updates the state
in place; unlike the reference, nothing is padded or sliced. ``which``
and ``pos`` come in computed by torch ops (``core/fm.py::_which_pos``),
as in the reference. These wrappers count their own launches
(``<wrapper>.launches``, and ``fm_bit_update.one_row_launches``
those on a one-row state), apart from the Bloom wrappers'.
"""
from __future__ import annotations

import torch

from . import bitset_or, build, probe, ref


def _flatten(state, which, pos):
    if state.dim() != 3:
        raise ValueError(f"state must be [n, maps, bits], got "
                         f"{tuple(state.shape)}")
    build.check(state, "state", torch.int32, tuple(state.shape),
                state.device)
    n, _, bits = state.shape
    # one launch: pos + bits * which (int32: maps * bits < 2**31)
    flat_pos = torch.add(pos, which, alpha=bits).to(torch.int32)
    return state.view(n, -1), flat_pos[:, None]


def fm_bit_update(state: torch.Tensor, syn_idx: torch.Tensor,
                  which: torch.Tensor, pos: torch.Tensor,
                  upd: torch.Tensor) -> torch.Tensor:
    """state [n, maps, bits] i32, in place: one lane per tuple at
    (which, pos); syn_idx / which / pos / upd [T] i32 (upd <= 0 and rows
    outside [0, n) are no-ops)."""
    flat, flat_pos = _flatten(state, which, pos)
    if state.device.type == "cpu":
        ref.bitset_max_update(flat, syn_idx, flat_pos, upd)
    elif bitset_or.launch(flat, syn_idx, flat_pos, upd):
        fm_bit_update.launches += 1
        fm_bit_update.one_row_launches += state.shape[0] == 1
    return state


fm_bit_update.launches = 0
# of those, launches on a one-row state: the data-source fresh sketch
fm_bit_update.one_row_launches = 0


def fm_probe_bit_update(state: torch.Tensor, keys_lo: torch.Tensor,
                        keys_hi: torch.Tensor, table_rows: torch.Tensor,
                        sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                        which: torch.Tensor, pos: torch.Tensor,
                        upd: torch.Tensor, *, n_probe: int) -> torch.Tensor:
    """Routing probe + FM lane scatter in one kernel, in place."""
    flat, flat_pos = _flatten(state, which, pos)
    if state.device.type == "cpu":
        rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                                n_probe=n_probe)
        ref.bitset_max_update(flat, rows, flat_pos, upd)
    elif bitset_or.launch_probe(flat, keys_lo, keys_hi, table_rows, sid_lo,
                                sid_hi, flat_pos, upd, n_probe=n_probe):
        fm_probe_bit_update.launches += 1
    return state


fm_probe_bit_update.launches = 0
