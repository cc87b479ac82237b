"""Stacked RHP/SimHash projection: routed row add of dense sign rows (port
of ``repro/kernels/rhp_project.py``).

RHP state is b running hyperplane dot products per synopsis (``[n, b]``
f32); a batch of T tuples adds ``v_t * sgn_t`` into its routed row:

    state[s, :] += sum_t [syn_t == s] * v_t * sgn[t, :]

The TPU kernels compute it as a one-hot MXU matmul. On Hopper it is a
deterministic routed row add written by hand in ``csrc/rhp_project.cu``:
the wrapper orders the routed rows with a stable ``torch.sort`` (equal
rows keep batch order) and the kernels give every state element one
owner thread, which adds its row's tuples in that order. No float
``atomicAdd``, so the state bytes are the same on every run. The source
makes three launches: a walk of the runs of fewer than ``LONG_RUN``
tuples, and, beside it on a second stream, a parallel pass that
multiplies the sign rows of the longer runs into a scratch of products
in sorted order, then a walk of those runs through a shared-memory ring
(batches of fewer than ``LONG_RUN`` tuples make the first launch only).

Both entry points update ``state`` in place and need no padding. On a
CPU tensor each wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernels or raises. ``<wrapper>.launches`` counts
calls that launched them, ``rhp_project_update.one_row_launches`` those on
a one-row state (the engine's data-source fold makes none: it sums the
batch with a torch reduction, as the reference does outside its kernel),
and ``<wrapper>.long_runs`` (a :class:`RunCount`) the runs of at least
``LONG_RUN`` tuples that the ring walk took, counted on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
# runs of at least this many tuples take the ring walk (``kLongRun`` in
# csrc/rhp_project.cu); a ring stage holds RING_ROWS sorted positions
# (4 * kRingGroups), counted from the group of 4 positions that holds a
# run's first
LONG_RUN = 256
RING_ROWS = 256
_SIGNATURES = {
    "rhp_project": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P),
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


class RunCount:
    """A count kept on the card, one int64 per device, that the kernels add
    to without a host synchronisation. ``int(count)`` reads it (and so
    synchronises); ``reset()`` sets it to 0."""

    def __init__(self):
        self._counts = {}

    def ptr(self, device: torch.device) -> int:
        c = self._counts.get(device)
        if c is None:
            c = self._counts[device] = torch.zeros((), dtype=torch.int64,
                                                   device=device)
        return c.data_ptr()

    def __int__(self) -> int:
        return sum(int(c) for c in self._counts.values())

    def reset(self) -> None:
        for c in self._counts.values():
            c.zero_()


def long_runs_of(rows: torch.Tensor, n: int) -> tuple:
    """(runs of at least ``LONG_RUN`` tuples, longest run) of a batch's
    routed rows ``rows`` [T] on a stack of ``n`` rows: what the ring walk
    takes, and the length of the longest add chain. Synchronises; for
    checks, not for the path."""
    kept = rows[(rows >= 0) & (rows < n)].long()
    if kept.numel() == 0:
        return 0, 0
    counts = torch.bincount(kept, minlength=n)
    return int((counts >= LONG_RUN).sum()), int(counts.max())


def _project(state, rows, values, signs, walked: RunCount) -> None:
    """Stable-sort the routed rows, then launch the kernels: the short-run
    walk, and (where a run can reach LONG_RUN) the products pass and the
    long-run walk, with scratch for their products and each long run's
    end (by row)."""
    srow, perm = torch.sort(rows, stable=True)
    n, b = state.shape
    t = rows.shape[0]
    prod = run_end = None               # no run can reach LONG_RUN
    if t >= LONG_RUN:
        prod = torch.empty(((b + 31) // 32, (t + 3) // 4, 32, 4),
                           dtype=torch.float32, device=state.device)
        run_end = torch.empty((n,), dtype=torch.int32, device=state.device)
    err = _lib().rhp_project(
        state.data_ptr(), n, b, srow.data_ptr(), perm.data_ptr(),
        values.data_ptr(), signs.data_ptr(), t, build.ptr(prod),
        build.ptr(run_end), walked.ptr(state.device),
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
    _project(state, syn_idx, values, signs, rhp_project_update.long_runs)
    rhp_project_update.launches += 1
    rhp_project_update.one_row_launches += state.shape[0] == 1
    return state


rhp_project_update.launches = 0
# of those, launches on a one-row state (a data-source fold would be one)
rhp_project_update.one_row_launches = 0
rhp_project_update.long_runs = RunCount()


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
    _project(state, rows, values, signs, rhp_probe_update.long_runs)
    rhp_probe_update.launches += 1
    return state


rhp_probe_update.launches = 0
rhp_probe_update.long_runs = RunCount()
