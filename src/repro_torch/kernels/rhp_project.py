"""Stacked RHP/SimHash projection: routed row add of dense sign rows (port
of ``repro/kernels/rhp_project.py``).

RHP state is b running hyperplane dot products per synopsis (``[n, b]``
f32); a batch of T tuples adds ``v_t * sgn_t`` into its routed row:

    state[s, :] += sum_t [syn_t == s] * v_t * sgn[t, :]

The TPU kernels compute it as a one-hot MXU matmul. On Hopper it is a
deterministic routed row add written by hand in ``csrc/rhp_project.cu``:
the wrapper orders the routed rows with a stable ``torch.sort`` (equal
rows keep batch order) and the kernel gives every state element one
owner thread, which adds its row's tuples in that order. No float
``atomicAdd``, so the state bytes are the same on every run.

Both entry points update ``state`` in place and need no padding. On a
CPU tensor each wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches, and ``rhp_project_update.one_row_launches`` those on a
one-row state (the engine's data-source fold makes none: it sums the
batch with a torch reduction, as the reference does outside its kernel).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rhp_project": (_P, _I, _I, _P, _P, _P, _P, _I, _P),
    "rhp_probe_rows": (_P, _P, _P, _I, _P, _P, _I, _P, _I, _P),
}


def _lib():
    return build.load("rhp_project", _SIGNATURES)


def _check_batch(state, values, signs, t):
    dev = state.device
    if state.dim() != 2:
        raise ValueError(f"state must be [n, b], got {tuple(state.shape)}")
    build.check(state, "state", torch.float32, tuple(state.shape), dev)
    build.check(values, "values", torch.float32, (t,), dev)
    build.check(signs, "signs", torch.float32, (t, state.shape[1]), dev)


def _project(state, rows, values, signs) -> None:
    """Stable-sort the routed rows, then launch the summing kernel."""
    srow, perm = torch.sort(rows, stable=True)
    n, b = state.shape
    err = _lib().rhp_project(
        state.data_ptr(), n, b, srow.data_ptr(), perm.data_ptr(),
        values.data_ptr(), signs.data_ptr(), rows.shape[0],
        build.stream(state.device))
    build.check_launch(err, "rhp_project")


def rhp_project_update(state: torch.Tensor, syn_idx: torch.Tensor,
                       values: torch.Tensor,
                       signs: torch.Tensor) -> torch.Tensor:
    """state [n, b] f32 += routed sign-row add, in place. syn_idx [T] i32
    (rows outside [0, n), e.g. -1, are dropped); values [T] f32 (mask
    folded in); signs [T, b] f32."""
    if state.device.type == "cpu":
        return ref.rhp_project_update(state, syn_idx, values, signs)
    build.require_cuda(state)
    t = syn_idx.shape[0]
    _check_batch(state, values, signs, t)
    build.check(syn_idx, "syn_idx", torch.int32, (t,), state.device)
    if t == 0 or state.numel() == 0:
        return state
    _project(state, syn_idx, values, signs)
    rhp_project_update.launches += 1
    rhp_project_update.one_row_launches += state.shape[0] == 1
    return state


rhp_project_update.launches = 0
# of those, launches on a one-row state (a data-source fold would be one)
rhp_project_update.one_row_launches = 0


def rhp_probe_update(state: torch.Tensor, keys_lo: torch.Tensor,
                     keys_hi: torch.Tensor, table_rows: torch.Tensor,
                     sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                     values: torch.Tensor, signs: torch.Tensor, *,
                     n_probe: int) -> torch.Tensor:
    """Routing probe + sign-row projection add, in place; the table
    operands as ``onehot_matmul.onehot_probe_scatter``. The probe runs as
    the kernel source's first small launch, into scratch rows."""
    if state.device.type == "cpu":
        return ref.rhp_probe_update(state, keys_lo, keys_hi, table_rows,
                                    sid_lo, sid_hi, values, signs,
                                    n_probe=n_probe)
    build.require_cuda(state)
    t = sid_lo.shape[0]
    _check_batch(state, values, signs, t)
    size = build.check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                             t, state.device)
    if t == 0 or state.numel() == 0:
        return state
    rows = torch.empty((t,), dtype=torch.int32, device=state.device)
    err = _lib().rhp_probe_rows(
        keys_lo.data_ptr(), keys_hi.data_ptr(), table_rows.data_ptr(), size,
        sid_lo.data_ptr(), sid_hi.data_ptr(), int(n_probe), rows.data_ptr(),
        t, build.stream(state.device))
    build.check_launch(err, "rhp_probe_rows")
    _project(state, rows, values, signs)
    rhp_probe_update.launches += 1
    return state


rhp_probe_update.launches = 0
