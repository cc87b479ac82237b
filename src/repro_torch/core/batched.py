"""Stacked maintenance of thousands of synopses of one kind (port of
``repro/core/batched.py``).

All synopses of a kind live in ONE stacked state with a leading
``[capacity]`` axis, and one update call maintains all of them. State is
a tensor, or a dict of tensors for kinds with several leaves;
:func:`tree_map` applies a function leaf by leaf.

Differences from the reference:

  * ``stacked_update``, ``stacked_step`` and ``set_row`` update the stack
    in place.
  * ``stacked_step`` calls the kind's ``tick`` over the whole stack (the
    reference vmaps the one-row ``step``), with the sliding-DFT kernel as
    its coefficient update.
  * The scan branch of ``stacked_update`` hands the batch to the kind's
    ``scan_update``, which groups it by row and takes each row's own
    tuples once (Lossy Counting: the hand-written scan kernel; the
    sampler: the hand-written reservoir kernel; GK: the hand-written
    requantize kernel, which requantizes the rows that took none too),
    where the reference vmaps ``add_batch`` over every row with the whole
    batch masked to that row's tuples. The rows' results are the same.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .synopsis import Synopsis


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to each leaf of a tensor or a dict of tensors (and the
    matching leaves of ``rest``). Dict keys come out sorted, as a JAX
    pytree's do, so a dict answer serializes to the reference's JSON."""
    if isinstance(tree, dict):
        return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    return ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
            else [tree])


def stacked_init(kind: Synopsis, capacity: int, device) -> Any:
    """``capacity`` copies of the kind's empty state on ``device`` (no
    default: nothing is allocated on a device the caller did not name)."""
    proto = kind.init(device)
    return tree_map(
        lambda x: x.expand((capacity,) + tuple(x.shape)).clone(), proto)


def grow(kind: Synopsis, stacked: Any, new_capacity: int) -> Any:
    """Grow capacity, padding NEW rows with the kind's init prototype (not
    zeros: some kinds' empty state is not all-zeros)."""
    capacity = tree_leaves(stacked)[0].shape[0]
    device = tree_leaves(stacked)[0].device
    fresh = stacked_init(kind, new_capacity - capacity, device)
    return tree_map(lambda x, f: torch.cat([x, f], dim=0), stacked, fresh)


def shrink(stacked: Any, new_capacity: int) -> Any:
    """Drop trailing rows (the grow() inverse); the caller has compacted
    live rows below ``new_capacity`` first."""
    return tree_map(lambda x: x[:new_capacity].clone(), stacked)


def stacked_update(kind: Synopsis, stacked: Any, syn_idx: torch.Tensor,
                   items, values, mask, source_rows=None) -> Any:
    """Routed + data-source update of a whole kind stack, in place.

    ``syn_idx`` may hold -1 for unrouted tuples; ``source_rows`` is an
    index vector of rows fed by ALL tuples (data-source synopses).
    Scatter-path kinds (``stacked_add_batch``) get the source
    contribution through mergeability: the batch is summarized ONCE into
    a fresh synopsis and merged into just the source rows. Scan-path
    kinds (``scan_update``) take the batch grouped by row: row r scans the
    tuples with ``mask & (syn_idx == r)``, a source row every tuple with
    ``mask``, each in batch order, as the reference's per-row masks give
    them."""
    if not hasattr(kind, "stacked_add_batch"):
        if not hasattr(kind, "scan_update"):
            raise NotImplementedError(
                f"{type(kind).__name__} has neither a scatter update "
                "(stacked_add_batch) nor a scan update (scan_update)")
        return kind.scan_update(stacked, syn_idx, items, values, mask,
                                source_rows)
    routed = mask & (syn_idx >= 0)
    rows = torch.clamp(syn_idx, min=0)
    out = kind.stacked_add_batch(stacked, rows, items, values, routed)
    if source_rows is not None:
        device = tree_leaves(out)[0].device
        fresh = kind.add_batch(kind.init(device), items, values, mask)
        src = source_rows.long()

        def fold(x, f):
            x[src] = kind.merge(x[src], f[None])
            return x
        out = tree_map(fold, out, fresh)
    return out


def stacked_step(kind: Synopsis, stacked: Any, values: torch.Tensor,
                 mask: torch.Tensor) -> Any:
    """Time-series path (DFT): one tick of every row of the stack, in
    place; row s takes ``values[s]`` where ``mask[s]`` and the other rows
    keep their state. The kind's ``tick`` updates the window leaves in
    torch and hands the coefficient planes to the hand-written sliding-DFT
    kernel (``kernels/ops.dft_step``; its plain version on the CPU)."""
    from repro_torch.kernels import ops     # kernels import core
    return kind.tick(stacked, values, mask, ops.dft_step)


def stacked_estimate(kind: Synopsis, stacked: Any, rows, *args: Any) -> Any:
    """Batched red path: estimates for ``rows`` of the stack in one call.
    ``rows`` is an index vector (None => every row); each extra query arg
    has a leading axis matching ``rows``."""
    if rows is None:
        capacity = tree_leaves(stacked)[0].shape[0]
        rows = torch.arange(capacity, dtype=torch.int32,
                            device=tree_leaves(stacked)[0].device)
    return kind.stacked_estimate(stacked, rows, *args)


def stacked_row(stacked: Any, row: int) -> Any:
    """A copy of one row's state."""
    return tree_map(lambda x: x[row].clone(), stacked)


def set_row(stacked: Any, row: int, state: Any) -> Any:
    """Overwrite one row in place."""
    def put(x, v):
        x[row] = v
        return x
    return tree_map(put, stacked, state)
