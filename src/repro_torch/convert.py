"""Carry a reference engine's contents into a port engine.

No counterpart in the JAX package. The contents travel as plain Python
and numpy, so the port never imports JAX; whoever holds a
``repro.service.SDE`` extracts them (``tests/test_torch_convert.py`` shows
how) and hands them to :func:`engine_from_contents`::

    {"site": str, "tuples_ingested": int, "batches_ingested": int,
     "stacks": [{"kind": registry name, "params": {...},
                 "state": ndarray [capacity, ...], or a dict of them,
                 "table_keys": int64 ndarray, "table_rows": int32 ndarray,
                 "table_max_probe": int, "source_rows": [int, ...]}, ...],
     "entries": [{"synopsis_id": str, "stack": index into "stacks",
                  "row": int, "stream_id": int or None,
                  "continuous": bool}, ...]}

Every stack's state keeps the reference's dtype and layout (float32
``[n, d, w]`` CountMin and AMS, ``[n, b]`` RHP; int32 HLL, Bloom and FM
lanes; DFT's six leaves, with int32 ``pos`` and ``count``; Lossy
Counting's ``counts`` and ``error`` float32 ``[n, k]``; the sampler's
``values`` float32 ``[n, S]`` and ``n_seen`` int32 ``[n]``; Sticky
Sampling's ``counts`` float32 ``[n, capacity]``, ``n_seen`` and
``epoch`` int32 ``[n]``; GK's ``values`` float32 ``[n, m]`` and ``n``
float32 ``[n]``, byte for byte, whatever order a row's values are in),
except that a uint32 leaf (the ``keys`` of
Lossy Counting and of Sticky Sampling, whose empty sentinel is
0xFFFFFFFF, and the sampler's ``items``) is viewed as int32, bit for
bit, as the port holds it.
The route table is taken slot for slot, so the port probes exactly the
reference's layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import batched
from repro_torch.service import engine, routing


def _as_port(x: np.ndarray) -> np.ndarray:
    """A state leaf in the port's dtype: uint32 identities as int32 bit
    patterns."""
    return x.view(np.int32) if x.dtype == np.uint32 else x


def engine_from_contents(contents: Dict[str, Any],
                         device="cuda") -> engine.SDE:
    """A port ``SDE`` on ``device`` holding the given engine contents."""
    sde = engine.SDE(site=contents.get("site", "site-0"), device=device)
    sde.tuples_ingested = int(contents.get("tuples_ingested", 0))
    sde.batches_ingested = int(contents.get("batches_ingested", 0))
    kinds = []
    for st in contents["stacks"]:
        kind = core.make_kind(st["kind"], **st["params"])
        state = batched.tree_map(
            lambda x: torch.from_numpy(_as_port(np.array(x))).to(sde.device),
            st["state"])
        capacity = batched.tree_leaves(state)[0].shape[0]
        stack = engine._KindStack(kind, capacity, sde.device)
        stack.state = state
        keys = np.asarray(st["table_keys"], np.int64)
        table = routing.RouteTable(keys.shape[0])
        if table.size != keys.shape[0]:
            raise ValueError(f"route table size {keys.shape[0]} is not a "
                             "power of two >= 64")
        table.keys = keys.copy()
        table.rows = np.asarray(st["table_rows"], np.int32).copy()
        table.count = int(np.count_nonzero(keys != routing.EMPTY))
        table.max_probe = int(st["table_max_probe"])
        table.version += 1
        stack.table = table
        for row in st["source_rows"]:
            stack.mark_source(int(row))
        sde.stacks[kind] = stack
        kinds.append(kind)
    for e in contents["entries"]:
        kind = kinds[e["stack"]]
        sde.stacks[kind].used[int(e["row"])] = True
        sid = e["stream_id"]
        sde.entries[e["synopsis_id"]] = engine._Entry(
            synopsis_id=e["synopsis_id"], kind_key=kind, row=int(e["row"]),
            stream_id=None if sid is None else int(sid),
            continuous=bool(e.get("continuous", False)))
    return sde
