"""The SDEaaS engine (port of ``repro/service/engine.py``): one always-on
service maintaining thousands of synopses for thousands of streams.

  * blue path: ``ingest(stream_ids, values)`` -- one update per synopsis
    kind updates every synopsis of that kind (stacked state = slot
    sharing). Stream ids are arbitrary 63-bit ints routed through a hashed
    open-addressing table (``service/routing.py``); the probe runs inside
    the kind's hand-written CUDA kernel (``kernels/ops.py`` registry).
  * red path: ``handle(request)`` adhoc queries and ``query_many`` --
    one stacked-estimate call per kind answers every query of that kind.

The port serves CountMin, AMS, HyperLogLog, Bloom, FM, RHP, DFT, Lossy
Counting, the chain sampler, Sticky Sampling and GK quantiles so far:
build (per stream, per stream of a source, data source), ingest, adhoc,
query_many, stop, status, flush and shutdown, with continuous queries
emitted eagerly. DFT is a time-series kind: each ingest batch ticks every
stream once with its last routed value (``_step_all``). Lossy Counting,
the sampler, Sticky Sampling and GK are scan-path kinds. Lossy Counting
declares no registry kernel, so ingest probes the rows and hands the
batch to ``batched.stacked_update``'s scan branch (its hand-written scan
kernel); the sampler, Sticky Sampling and GK declare one (the reservoir
update, the sticky scan, the requantize, which takes every row of the
stack on every batch, as the reference's vmap does), the probe fused in.
GK's queries take ``qs`` (quantiles, default ``[0.5]``); its continuous
queries answer the default.

Differences from the reference:

  * ``device`` is explicit and defaults to ``"cuda"``; without a card the
    constructor raises. Nothing falls back to the CPU on its own.
  * State is updated in place (the reference donates the state buffer).
  * The update ALWAYS goes through a hand-written kernel: the registry's
    for a kind that declares one, the scan kernel behind
    ``batched.stacked_update`` for a scan-path kind. There is no
    ``backend="xla"`` counterpart, which would run the plain version on
    the card. On the CPU the wrappers run their plain versions.
  * No mesh, sharding, pipelining, durability or migration yet. Requests
    of later slices answer ``ok=False`` and name the slice they wait for.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import batched
from repro_torch.core.synopsis import Synopsis, kind_params
from repro_torch.kernels import ops as kops
from . import api, pipeline, routing

# request types of later slices -> the slice each waits for
_WAITING = {
    api.LoadSynopsis: "pluggable kinds",
    api.FederatedQuery: "federation",
    api.BuildMultidim: "multidim",
    api.IngestMultidim: "multidim",
    api.SubpopQuery: "subpop",
    api.TrackOutliers: "outliers",
    api.UntrackOutliers: "outliers",
}


@dataclasses.dataclass
class _Entry:
    synopsis_id: str
    kind_key: Any                 # the frozen kind dataclass
    row: int
    stream_id: Optional[int]      # None => data-source synopsis
    federated: bool = False
    responsible_site: Optional[str] = None
    continuous: bool = False
    source_id: Optional[str] = None


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _halves(sids: np.ndarray, device: torch.device):
    """int64 ids -> their uint32 (lo, hi) halves as int32 bit patterns."""
    lo, hi = routing.split64(sids)
    return (_to_device(lo.view(np.int32), device),
            _to_device(hi.view(np.int32), device))


class _KindStack:
    """All synopses of one kind: stacked state + hashed routing table."""

    def __init__(self, kind: Synopsis, capacity: int, device: torch.device):
        self.kind = kind
        self.capacity = capacity
        self.device = device
        self.state = batched.stacked_init(kind, capacity, device)
        self.table = routing.RouteTable()  # stream id -> row (host side)
        self.source_rows: List[int] = []   # rows fed by ALL tuples
        self.used: List[bool] = [False] * capacity
        self.is_timeseries = hasattr(kind, "step")
        self._source_idx = None            # device cache, source_rows_idx()
        self._free: Optional[List[int]] = None   # alloc free list (lazy)
        self._dev_table = None             # device mirror of self.table
        self._dev_table_version = -1

    def device_table(self):
        """(keys_lo, keys_hi, rows) int32 device mirror of the routing
        table, rebuilt only when the host table mutated."""
        if (self._dev_table is None
                or self._dev_table_version != self.table.version):
            lo, hi = _halves(self.table.keys, self.device)
            self._dev_table = (lo, hi, _to_device(self.table.rows,
                                                  self.device))
            self._dev_table_version = self.table.version
        return self._dev_table

    @property
    def n_probe(self) -> int:
        """Probe bound: the table's longest insert displacement,
        pow2-rounded as in the reference."""
        return _next_pow2(self.table.max_probe)

    def source_rows_idx(self) -> Optional[torch.Tensor]:
        """int64 index vector of data-source rows; None when there are
        none. Cached on device; invalidated on lifecycle changes."""
        if not self.source_rows:
            return None
        if self._source_idx is None:
            self._source_idx = torch.tensor(self.source_rows,
                                            dtype=torch.int64,
                                            device=self.device)
        return self._source_idx

    def mark_source(self, row: int):
        self.source_rows.append(row)
        self._source_idx = None

    def row_bytes(self) -> int:
        """Device bytes of ONE row slice of the stacked state."""
        return sum(x[0].numel() * x.element_size()
                   for x in batched.tree_leaves(self.state))

    def alloc(self) -> int:
        """Hand out the lowest free row, doubling capacity when full."""
        if self._free is None:
            self._free = [i for i, u in enumerate(self.used)
                          if not u][::-1]
        if not self._free:
            old_cap = self.capacity
            self.capacity *= 2
            self.state = batched.grow(self.kind, self.state, self.capacity)
            self.used.extend([False] * old_cap)
            self._free = list(range(self.capacity - 1, old_cap - 1, -1))
            self._source_idx = None
        row = self._free.pop()
        self.used[row] = True
        return row

    def free_rows(self, rows: List[int]):
        """Release rows AND re-initialize their state (a reused row must
        start fresh); the routing table compacts by re-insert."""
        for row in rows:
            self.used[row] = False
            if row in self.source_rows:
                self.source_rows.remove(row)
        self._source_idx = None
        self._free = None
        self.table.remove_rows(np.asarray(rows, np.int32))
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        fresh = batched.stacked_init(self.kind, len(rows), self.device)

        def reset(x, f):
            x[idx] = f
            return x
        self.state = batched.tree_map(reset, self.state, fresh)


class SDE:
    """One SDEaaS instance on one device (``"cuda"`` by default)."""

    def __init__(self, site: str = "site-0", device="cuda",
                 continuous_out_cap: Optional[int] = 65536):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SDE(device='cuda') needs a CUDA card and none is "
                "available; pass device='cpu' to run on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.site = site
        self.device = device
        self.stacks: Dict[Any, _KindStack] = {}
        self.entries: Dict[str, _Entry] = {}
        # bounded: a consumer that falls behind loses the OLDEST
        # responses (counted in .dropped), never stalls ingest
        self.continuous_out = pipeline.BoundedResponseLog(continuous_out_cap)
        self.tuples_ingested = 0
        self.batches_ingested = 0   # monotonic; keys continuous responses
        # continuous queries grouped by kind, rebuilt lazily after any
        # lifecycle change
        self._cq_groups: Optional[Dict[Any, Any]] = None

    # ------------------------------------------------------------------
    # red path: requests
    # ------------------------------------------------------------------
    def handle(self, snippet: str | dict) -> api.Response:
        try:
            req = api.parse_request(snippet)
            if isinstance(req, api.BuildSynopsis):
                return self._build(req)
            if isinstance(req, api.StopSynopsis):
                return self._stop(req)
            if isinstance(req, api.AdHocQuery):
                return self._query(req)
            if isinstance(req, api.QueryMany):
                return self._query_many_req(req)
            if isinstance(req, api.Ingest):
                return self._ingest_req(req)
            if isinstance(req, api.Flush):
                return self._flush_req(req)
            if isinstance(req, api.Shutdown):
                return self._shutdown_req(req)
            if isinstance(req, api.StatusReport):
                return self._status(req)
            if type(req) in _WAITING:
                raise NotImplementedError(
                    f"{type(req).__name__} is not served by the PyTorch "
                    f"port yet: it waits for the {_WAITING[type(req)]} "
                    "slice")
            raise ValueError(f"unhandled request {req}")
        except Exception as e:  # noqa: BLE001 - service returns errors
            rid = ""
            try:
                rid = json.loads(snippet)["request_id"] if isinstance(
                    snippet, str) else snippet.get("request_id", "")
            except Exception:
                pass
            return api.Response(request_id=rid, ok=False, error=repr(e))

    def _build(self, req: api.BuildSynopsis) -> api.Response:
        kind = core.make_kind(req.kind, **req.params)
        if self.device.type == "cuda":
            kops.check_on_card(kind)
        # validate EVERY routed stream id before any allocation: a failed
        # build must not commit partial entries
        if req.per_stream_of_source:
            sid_list = (req.stream_ids if req.stream_ids is not None
                        else range(req.n_streams))
            for sid in sid_list:
                _check_stream_id(sid)
            # canonicalize + dedupe: the entry id and the routed key agree
            sid_list = list(dict.fromkeys(int(s) for s in sid_list))
        else:
            sid_list = None
            _check_stream_id(req.stream_id)
        stack = self.stacks.get(kind)
        if stack is None:
            cap = 64
            if sid_list:
                cap = max(64, _next_pow2(len(sid_list)))
            stack = _KindStack(kind, cap, self.device)
            self.stacks[kind] = stack

        def add_one(sid: Optional[int], syn_id: str, routed: list):
            # reuse: same id => same synopsis shared across workflows
            if syn_id in self.entries:
                return
            row = stack.alloc()
            if sid is None:
                stack.mark_source(row)
            else:
                routed.append((int(sid), row))
            self.entries[syn_id] = _Entry(
                synopsis_id=syn_id, kind_key=kind, row=row, stream_id=sid,
                federated=req.federated,
                responsible_site=req.responsible_site,
                continuous=req.continuous, source_id=req.source_id)

        routed: List[tuple] = []
        if sid_list is not None:
            for sid in sid_list:
                add_one(int(sid), f"{req.synopsis_id}/{sid}", routed)
        else:
            add_one(req.stream_id, req.synopsis_id, routed)
        if routed:
            # one vectorized table insert for the whole build
            stack.table.insert_many(
                np.asarray([s for s, _ in routed], np.int64),
                np.asarray([r for _, r in routed], np.int32))
        self._cq_groups = None
        return api.Response(request_id=req.request_id,
                            synopsis_id=req.synopsis_id,
                            params=kind_params(kind))

    def _stop(self, req: api.StopSynopsis) -> api.Response:
        ids = [k for k in self.entries
               if k == req.synopsis_id or k.startswith(req.synopsis_id + "/")]
        if not ids:
            return api.Response(request_id=req.request_id, ok=False,
                                error=f"unknown synopsis {req.synopsis_id!r}")
        freed: Dict[Any, List[int]] = {}
        for k in ids:
            e = self.entries.pop(k)
            freed.setdefault(e.kind_key, []).append(e.row)
        for kind, rows in freed.items():
            self.stacks[kind].free_rows(rows)
            # a kind nothing references anymore releases its stack state
            if not any(e.kind_key == kind for e in self.entries.values()):
                del self.stacks[kind]
        self._cq_groups = None
        return api.Response(request_id=req.request_id,
                            synopsis_id=req.synopsis_id, value=len(ids))

    def _query(self, req: api.AdHocQuery) -> api.Response:
        return self.query_many([req])[0]

    def query_many(self, requests: Sequence[api.AdHocQuery]
                   ) -> List[api.Response]:
        """Answer N ad-hoc queries with ONE stacked-estimate call per kind
        touched: queries are grouped by kind and their args batched into
        padded device tensors."""
        responses: List[Optional[api.Response]] = [None] * len(requests)
        groups: Dict[Any, List[int]] = {}
        for i, req in enumerate(requests):
            e = self.entries.get(req.synopsis_id)
            if e is None:
                responses[i] = api.Response(
                    request_id=req.request_id, ok=False,
                    error=f"unknown synopsis {req.synopsis_id!r}")
            elif req.query is not None and not isinstance(req.query, dict):
                # fails alone -- never poisons the rest of the batch
                responses[i] = api.Response(
                    request_id=req.request_id, ok=False,
                    error="query must be an object, got "
                          f"{type(req.query).__name__}")
            else:
                groups.setdefault(e.kind_key, []).append(i)
        for kind, idxs in groups.items():
            stack = self.stacks[kind]
            rows = [self.entries[requests[i].synopsis_id].row for i in idxs]
            vals, errs = self._estimate_rows(
                kind, stack, rows, [requests[i].query or {} for i in idxs])
            for i, val, err in zip(idxs, vals, errs):
                if err is not None:
                    responses[i] = api.Response(
                        request_id=requests[i].request_id,
                        synopsis_id=requests[i].synopsis_id,
                        ok=False, error=err)
                else:
                    responses[i] = api.Response(
                        request_id=requests[i].request_id,
                        synopsis_id=requests[i].synopsis_id, value=val,
                        params=kind_params(kind))
        return responses

    def _query_many_req(self, req: api.QueryMany) -> api.Response:
        subs: List[Optional[api.AdHocQuery]] = []
        prefail: Dict[int, api.Response] = {}
        for i, q in enumerate(req.queries):
            rid = f"{req.request_id}/{i}"
            if isinstance(q, dict):
                subs.append(api.AdHocQuery(
                    request_id=rid, synopsis_id=q.get("synopsis_id", ""),
                    query=q["query"] if "query" in q else {}))
            else:
                # a malformed entry fails alone; the rest of the batch runs
                prefail[i] = api.Response(
                    request_id=rid, ok=False,
                    error="query entry must be an object, got "
                          f"{type(q).__name__}")
                subs.append(None)
        answered = iter(self.query_many([s for s in subs if s is not None]))
        rs = [prefail[i] if s is None else next(answered)
              for i, s in enumerate(subs)]
        n_fail = sum(1 for r in rs if not r.ok)
        return api.Response(request_id=req.request_id, ok=n_fail == 0,
                            error=(f"{n_fail}/{len(rs)} queries failed"
                                   if n_fail else ""),
                            value=[dataclasses.asdict(r) for r in rs])

    def _ingest_req(self, req: api.Ingest) -> api.Response:
        """JSON blue path: the ack carries the monotonic batch counter
        (keys this batch's ``cq/<id>/<batch>`` continuous responses)."""
        batch = self.ingest(req.stream_ids, req.values, req.mask)
        return api.Response(
            request_id=req.request_id,
            value=dict(batch=batch, tuples_ingested=self.tuples_ingested,
                       in_flight=0))

    def _flush_req(self, req: api.Flush) -> api.Response:
        drained = self.flush()
        return api.Response(
            request_id=req.request_id,
            value=dict(drained=drained,
                       batches_ingested=self.batches_ingested,
                       continuous_unread=len(self.continuous_out),
                       continuous_dropped=self.continuous_out.dropped))

    def _shutdown_req(self, req: api.Shutdown) -> api.Response:
        """Clean stop: ack with the final counters, then ``close()``. The
        engine stays usable (a later build simply re-allocates)."""
        drained = self.flush()
        value = dict(drained=drained,
                     tuples_ingested=self.tuples_ingested,
                     batches_ingested=self.batches_ingested,
                     synopses=len(self.entries),
                     continuous_unread=len(self.continuous_out),
                     continuous_dropped=self.continuous_out.dropped)
        self.close()
        return api.Response(request_id=req.request_id, value=value)

    def _status(self, req: api.StatusReport) -> api.Response:
        per_row = {k: s.row_bytes() for k, s in self.stacks.items()}
        info = {
            sid: dict(kind=type(e.kind_key).__name__,
                      params=kind_params(e.kind_key),
                      stream=e.stream_id, federated=e.federated,
                      memory_bytes=per_row[e.kind_key])
            for sid, e in self.entries.items()}
        # the reference's probe counters, with its Python types; each reads
        # 0 until the slice that feeds it lands (ROADMAP queue 1)
        return api.Response(
            request_id=req.request_id, value=info,
            params=dict(
                site=self.site,
                reconcile_count=0,          # serving layers (reconciler)
                migrated_rows=0,            # snapshots and migration
                rebalance_imbalance=0.0,    # serving layers (balancer)
                checkpoint_bytes=0,         # snapshots and migration
                dirty_rows=0,               # snapshots and migration
                wal_appends=0,              # serving layers (WAL)
                subpop_cover_keys=0,        # multidim, subpop, outliers
                outlier_emits=0,            # multidim, subpop, outliers
                device=str(self.device)))

    # ------------------------------------------------------------------
    # blue path: data
    # ------------------------------------------------------------------
    def ingest(self, stream_ids, values, mask=None) -> int:
        """One batch of (stream, value) tuples; updates EVERY maintained
        synopsis of every kind with one registry-kernel update per kind
        stack (routing probe, routed rows and data-source rows).

        Stream ids are arbitrary ints in ``[0, 2**63)``; unrepresentable
        ids (negative, or uint64 values >= 2**63) are masked out. Returns
        the batch's monotonic id, which keys its continuous responses
        (``cq/<synopsis>/<id>``); those are emitted before returning."""
        sid_arr = np.asarray(stream_ids)
        vals_np = np.asarray(values, np.float32)
        if len(vals_np) != len(sid_arr):
            raise ValueError(
                f"ingest batch mismatch: {len(sid_arr)} stream_ids vs "
                f"{len(vals_np)} values — the two must align 1:1")
        t = len(sid_arr)
        if mask is None:
            mask = np.ones(t, bool)
        else:
            mask = np.asarray(mask, bool)
            if len(mask) != t:
                raise ValueError(
                    f"ingest batch mismatch: {t} stream_ids vs "
                    f"{len(mask)} mask entries — the two must align 1:1")
        sid64 = sid_arr.astype(np.int64)
        mask = mask & (sid64 >= 0)
        self.tuples_ingested += int(mask.sum())
        self.batches_ingested += 1
        batch_id = self.batches_ingested
        sid_lo, sid_hi = _halves(sid64, self.device)
        items = _to_device(routing.fold64(sid64).view(np.int32), self.device)
        vals = _to_device(vals_np, self.device)
        msk = _to_device(mask, self.device)
        for stack in self.stacks.values():
            if stack.is_timeseries:
                self._ingest_timeseries(stack, sid_lo, sid_hi, vals, msk)
            else:
                self._ingest_stack(stack, sid_lo, sid_hi, items, vals, msk)
        pending = self._dispatch_continuous(batch_id)
        if pending is not None:
            self._retire_batch(pending)
        return batch_id

    def flush(self) -> int:
        """Pipeline barrier. Continuous queries run eagerly in this port,
        so nothing is ever pending: returns the 0 batches drained."""
        return 0

    def close(self) -> None:
        """Release every kind stack and entry. Idempotent; the engine
        stays usable."""
        self.stacks.clear()
        self.entries.clear()
        self._cq_groups = None

    def _ingest_stack(self, stack: _KindStack, sid_lo, sid_hi, items,
                      vals, msk):
        klo, khi, trows = stack.device_table()
        stack.state = _update(stack.kind, stack.n_probe, stack.state, klo,
                              khi, trows, sid_lo, sid_hi, items, vals, msk,
                              stack.source_rows_idx())

    def _ingest_timeseries(self, stack: _KindStack, sid_lo, sid_hi, vals,
                           msk):
        """Time-series kinds (DFT): one tick per stream per batch -- the
        batch is a StatStream 'basic window'; the last routed value per
        stream wins. Data-source rows are not ticked, as in the
        reference."""
        klo, khi, trows = stack.device_table()
        stack.state = _step_all(stack.kind, stack.n_probe, stack.state, klo,
                                khi, trows, sid_lo, sid_hi, vals, msk)

    def _dispatch_continuous(self, batch_id: int
                             ) -> Optional[pipeline.PendingBatch]:
        """Evaluate ALL continuous queries of a kind per ingest batch in a
        single stacked-estimate call. None when there are none."""
        if self._cq_groups is None:
            self._cq_groups = self._plan_continuous()
        if not self._cq_groups:
            return None
        emissions = []
        for kind, (ids, rows_dev, args, take) in self._cq_groups.items():
            out = kops.estimate_all(kind, self.stacks[kind].state, rows_dev,
                                    *args)
            emissions.append((ids, take, out))
        return pipeline.PendingBatch(batch_id, emissions)

    def _retire_batch(self, pending: pipeline.PendingBatch) -> None:
        """Materialize one batch's continuous outputs into
        ``continuous_out``."""
        for ids, take, out in pending.emissions:
            out = batched.tree_map(lambda x: x.cpu().numpy(), out)
            for i, sid in enumerate(ids):
                self.continuous_out.append(api.Response(
                    request_id=f"cq/{sid}/{pending.batch_id}",
                    synopsis_id=sid, value=take(out, i)))

    def _plan_continuous(self) -> Dict[Any, Any]:
        by_kind: Dict[Any, List[Any]] = {}
        for sid, e in self.entries.items():
            if e.continuous:
                by_kind.setdefault(e.kind_key, []).append((sid, e.row))
        groups: Dict[Any, Any] = {}
        for kind, members in by_kind.items():
            ids = [sid for sid, _ in members]
            rows_arr = _pad_rows([row for _, row in members])
            args, take, _ = _plan_queries(kind, [{}] * len(rows_arr),
                                          self.device)
            groups[kind] = (ids, _to_device(rows_arr, self.device), args,
                            take)
        return groups

    # ------------------------------------------------------------------
    def _estimate_rows(self, kind, stack: _KindStack, rows: Sequence[int],
                       queries: Sequence[Dict[str, Any]]):
        """Answer ``len(rows)`` queries against one kind stack with ONE
        stacked-estimate call. Rows and per-query args are padded to the
        next power of two, as in the reference."""
        n = len(rows)
        rows_arr = _pad_rows(rows)
        args, take, errors = _plan_queries(
            kind, list(queries) + [{}] * (len(rows_arr) - n), self.device)
        out = kops.estimate_all(kind, stack.state,
                                _to_device(rows_arr, self.device), *args)
        out = batched.tree_map(lambda x: x.cpu().numpy(), out)
        return [take(out, i) for i in range(n)], errors[:n]

    def state_of(self, synopsis_id: str):
        """A copy of one synopsis' state."""
        e = self.entries[synopsis_id]
        return batched.stacked_row(self.stacks[e.kind_key].state, e.row)

    def memory_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for s in self.stacks.values()
                   for x in batched.tree_leaves(s.state))


# ---------------------------------------------------------------------------
# blue-path update: the kind's registry kernel (probe fused unless
# SDE_FUSED_PROBE is off), routed rows and data-source rows in one call,
# state updated in place; the chain sampler's is the reservoir kernel,
# Sticky Sampling's the sticky-scan kernel, GK's the requantize kernel. A
# kind without a registry kernel (Lossy Counting) takes the probe, then
# ``batched.stacked_update``, as in the reference; SDE_FUSED_PROBE does
# not touch it. Time-series kinds take the step path (``_step_all``)
# instead.
# ---------------------------------------------------------------------------
def _update(kind, n_probe, state, klo, khi, trows, sid_lo, sid_hi, items,
            vals, msk, src_rows=None):
    kops.DISPATCH_COUNT[f"update:{type(kind).__name__}"] += 1
    kernel = kops.resolve_update_kernel(kind)
    if kernel is not None:
        return kernel(state, klo, khi, trows, sid_lo, sid_hi, items, vals,
                      msk, src_rows, n_probe=n_probe)
    syn_idx = kops.route_probe(klo, khi, trows, sid_lo, sid_hi,
                               n_probe=n_probe)          # -1 => unrouted
    return batched.stacked_update(kind, state, syn_idx, items, vals, msk,
                                  src_rows)


def _step_all(kind, n_probe, state, klo, khi, trows, sid_lo, sid_hi, vals,
              msk):
    """Probe the batch's rows, keep each row's LAST routed tuple, and tick
    every row of the stack once (``batched.stacked_step``), in place. The
    last tuple is found exactly: an integer scatter-max of the tuple
    order, unrouted tuples sent to an overflow slot past the stack."""
    capacity = batched.tree_leaves(state)[0].shape[0]
    syn_idx = kops.route_probe(klo, khi, trows, sid_lo, sid_hi,
                               n_probe=n_probe)
    routed = msk & (syn_idx >= 0)
    rows = torch.where(routed, syn_idx, capacity).long()
    order = torch.arange(sid_lo.shape[0], dtype=torch.int32,
                         device=sid_lo.device)
    winner = torch.full((capacity + 1,), -1, dtype=torch.int32,
                        device=sid_lo.device)
    winner.scatter_reduce_(0, rows, torch.where(routed, order, -1),
                           reduce="amax")
    winner = winner[:-1]
    hit = winner >= 0
    per_row = torch.where(hit, vals[winner.clamp(min=0).long()], 0.0)
    return batched.stacked_step(kind, state, per_row, hit)


# ---------------------------------------------------------------------------
# red-path query planning: normalize N query dicts for one kind into padded
# batched device args + a per-query result slicer. CountMin, Bloom, Lossy
# Counting and Sticky Sampling take per-query ``items`` (default ``[0]``)
# and GK per-query ``qs`` (float32, default ``[0.5]``) as ONE [N, L] arg
# (L = padded max arg length, padded with 0); AMS, HyperLogLog, FM,
# RHP, DFT and the sampler are arg-free and return their estimate per row
# (AMS's the L2-norm^2; RHP's a dict: signature, hamming_weight, bucket;
# DFT's a dict: bucket, coeffs, coords; the sampler's a dict: items as
# uint32, valid, values).
# ---------------------------------------------------------------------------

_ITEM_KINDS = (core.CountMin, core.BloomFilter, core.LossyCounting,
               core.StickySampling)

_next_pow2 = routing.next_pow2


def _pad_rows(rows: Sequence[int]) -> np.ndarray:
    """Pad a row-index batch to the next power of two (padding rows point
    at row 0 -- reads are side-effect free -- and their results are
    sliced off)."""
    padded = np.zeros((_next_pow2(len(rows)),), np.int32)
    padded[:len(rows)] = rows
    return padded


def _check_stream_id(sid: Optional[int]) -> None:
    """Reject stream ids the engine cannot represent. None (data-source
    synopses) is always valid; anything in [0, 2**63) routes."""
    if sid is not None and not (0 <= int(sid) <= routing.MAX_STREAM_ID):
        raise ValueError(
            f"stream id {sid} outside [0, 2**63); stream ids must be "
            "non-negative 63-bit ints")


def _coerce_items(raw, default) -> np.ndarray:
    """Per-query ``items`` arg -> uint32 identities, folding 64-bit item
    ids the same way ingest folds stream ids."""
    arr = np.asarray(raw if raw is not None else default, np.int64).ravel()
    if arr.size and (arr.min() < 0):
        raise ValueError(f"negative item id {int(arr.min())}")
    return routing.fold64(arr)


def _plan_queries(kind, queries: Sequence[Dict[str, Any]], device):
    """Returns ``(args, take, errors)``: ``args`` are the batched device
    tensors to pass to ``kernels.ops.estimate_all`` after the rows
    argument, ``take(out, i)`` slices query ``i``'s value out of the
    (host-side) batched output, and ``errors[i]`` is an error string when
    query ``i``'s args failed to coerce (that query gets default args so
    ONE bad query never poisons the rest of the batch)."""
    errors: List[Optional[str]] = [None] * len(queries)
    if isinstance(kind, core.GKQuantiles):
        key, default, np_dtype = "qs", [0.5], np.float32
    elif isinstance(kind, _ITEM_KINDS):
        key, default, np_dtype = "items", [0], np.uint32
    else:
        def take(out, i):
            return batched.tree_map(lambda x: x[i], out)
        return (), take, errors
    lists = []
    for i, q in enumerate(queries):
        try:
            if key == "items":
                lists.append(_coerce_items(q.get(key), default))
            else:
                lists.append(
                    np.asarray(q.get(key, default), np_dtype).ravel())
        except (TypeError, ValueError, OverflowError) as e:
            lists.append(np.asarray(default, np_dtype).ravel())
            errors[i] = f"bad {key!r} in query: {e!r}"
    lens = [len(lst) for lst in lists]
    width = _next_pow2(max(max(lens), 1))
    arg = np.zeros((len(queries), width), np_dtype)
    for i, lst in enumerate(lists):
        arg[i, :len(lst)] = lst

    def take(out, i):
        return out[i, :lens[i]]
    if key == "items":            # uint32 identities as int32 bit patterns
        arg = arg.view(np.int32)
    return (_to_device(arg, device),), take, errors
