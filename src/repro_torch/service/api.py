"""SDE API -- JSON request/response schemata (paper Section 3, Figure 1).

A copy of ``repro/service/api.py`` (pure Python), kept in the port so it
never imports the JAX package. Every request type of the reference parses
here; the port's engine answers the ones outside this slice with
``ok=False``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Request:
    """Every request carries an id plus optional multi-client routing
    fields (used by the gateway front door, ignored by a bare engine):

    tenant: synopsis-namespace key. The gateway prefixes every
      ``synopsis_id`` with ``"<tenant>::"`` so tenants can neither
      address nor collide with each other's synopses. The STREAM id
      space stays shared — the paper's claim (e): many concurrent
      workflows maintain synopses over the same streams.
    client_id: identifies the submitting client within a connection;
      continuous-query responses route to the building client's bounded
      per-client response log.
    """
    request_id: str
    tenant: str = ""
    client_id: str = ""


@dataclasses.dataclass
class BuildSynopsis(Request):
    """Create (or start maintaining) a synopsis on-the-fly.

    stream_id: single-stream synopsis target; None => data-source synopsis.
      Stream ids are ARBITRARY non-negative 63-bit ints (hashed user ids,
      sensor UUIDs, ...) — routing is hashed, there is no dense-table
      range cap and no re-keying requirement.
    per_stream_of_source: one synopsis per stream of the source with a
      single request (paper: 'a sample per stock ... single request');
      covers streams ``range(n_streams)``, or exactly ``stream_ids``
      when that list is given (sparse / hashed id populations).
    """
    synopsis_id: str = ""
    kind: str = "countmin"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stream_id: Optional[int] = None
    source_id: Optional[str] = None
    per_stream_of_source: bool = False
    n_streams: int = 0                    # per-stream builds: id range size
    stream_ids: Optional[List[int]] = None  # per-stream builds: explicit ids
    parallelism: int = 1                  # requested degree (data-source)
    scheme: str = "partition"             # partition | round_robin
    federated: bool = False
    responsible_site: Optional[str] = None
    continuous: bool = False              # emit estimate on every update


@dataclasses.dataclass
class StopSynopsis(Request):
    synopsis_id: str = ""


@dataclasses.dataclass
class LoadSynopsis(Request):
    """Plug an external synopsis definition while the service runs."""
    kind_name: str = ""
    factory_path: str = ""                # "module:callable"


@dataclasses.dataclass
class AdHocQuery(Request):
    synopsis_id: str = ""
    query: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FederatedQuery(Request):
    """Global estimate over every site of a federation (paper Case 2/3:
    the responsible site synthesizes the answer from the sites' partial
    synopses). Served by ``Federation.handle`` — on a mesh-backed
    federation the site merge runs as ONE compiled collective over the
    ``site``/``pod`` axis; otherwise the legacy host-side gather+merge
    answers. The response's ``params`` carries the fig 5d communication
    metrics: ``collective_operand_bytes`` (what the collective merge
    ships across the site axis), ``host_merge_bytes`` (what gathering
    every site's state to the responsible host ships — also exactly what
    the executed path shipped when ``path == "host"``), ``path``
    ("collective" | "host") and ``sites`` (how many sites contributed a
    partial state)."""
    synopsis_id: str = ""
    query: Dict[str, Any] = dataclasses.field(default_factory=dict)
    responsible_site: str = ""


@dataclasses.dataclass
class QueryMany(Request):
    """Answer many ad-hoc queries in one request (SDEaaS batched red path).

    Each entry of ``queries`` is ``{"synopsis_id": ..., "query": {...}}``;
    the engine groups them by synopsis kind and evaluates every group with
    a single jitted stacked-estimate dispatch. The response ``value`` is
    the list of per-query response dicts in request order.
    """
    queries: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Ingest(Request):
    """Blue-path data over JSON: one batch of (stream, value) tuples.

    The ack's ``value`` carries the monotonic batch counter assigned to
    this batch (``{"batch": n, ...}``) — the same counter that keys the
    batch's continuous-query response ids (``cq/<synopsis>/<n>``) — plus
    the pipeline's current in-flight depth, so a JSON-driven workflow
    can correlate deferred continuous output with the ingest that
    produced it under pipelined execution.
    """
    stream_ids: List[Any] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)
    mask: Optional[List[bool]] = None


@dataclasses.dataclass
class BuildMultidim(Request):
    """Build a multidimensional synopsis family in one request.

    ``dims`` maps dimension name -> finite domain of attribute values;
    ``levels`` optionally restricts the materialized group-by family to
    the listed dimension subsets (default: every subset — the full
    dyadic family of ``core.multidim``). The engine allocates one
    synopsis of ``kind`` per group across every level under entry ids
    ``<synopsis_id>/<group key>`` — ordinary per-stream entries on the
    fused blue path.
    """
    synopsis_id: str = ""
    kind: str = "countmin"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dims: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    levels: Optional[List[List[str]]] = None
    continuous: bool = False


@dataclasses.dataclass
class IngestMultidim(Request):
    """Blue-path data as attribute-tagged records: ``records[i]`` maps
    every declared dimension to a value; the engine expands each record
    to its per-level group keys host-side and feeds ONE fused ingest
    per kind. ``items`` optionally carries per-record item identities
    (user ids, ...) for item-hashing sketches (HLL/Bloom/FM/CM/AMS);
    default is the record's leaf-group key, making coarse groups count
    distinct leaf subpopulations."""
    synopsis_id: str = ""
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)
    mask: Optional[List[bool]] = None
    items: Optional[List[int]] = None


@dataclasses.dataclass
class SubpopQuery(Request):
    """Estimate over an arbitrary subpopulation: ``where`` is a
    conjunction of per-dimension predicates (value or list of values per
    dimension); the engine expands it into the covering key set of the
    matching level and answers with ONE fused
    merge-covering-set-then-estimate dispatch. ``query`` carries the
    kind's usual estimate args (as in ``AdHocQuery``)."""
    synopsis_id: str = ""
    where: Dict[str, Any] = dataclasses.field(default_factory=dict)
    query: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrackOutliers(Request):
    """Start a continuous outlier workflow over a multidim family: each
    ingest tick, every group of ``level`` is estimated alongside the
    population group — off the SAME maintained synopses, zero new
    builds — and groups whose stat deviates from the level's mean by
    ``threshold`` robust z-scores AND at least ``min_dev`` absolutely
    are emitted through the continuous-response path
    (``ow/<workflow>/<batch>``)."""
    workflow_id: str = ""
    synopsis_id: str = ""
    level: Optional[List[str]] = None     # default: the leaf level
    query: Dict[str, Any] = dataclasses.field(default_factory=dict)
    threshold: float = 3.0
    min_dev: float = 0.0


@dataclasses.dataclass
class UntrackOutliers(Request):
    workflow_id: str = ""


@dataclasses.dataclass
class Flush(Request):
    """Pipeline barrier: materialize every in-flight continuous batch
    into the engine's continuous output before the ack returns. The
    ack's ``value`` reports how many batches were drained. A no-op (0
    drained) on an eager engine or an idle pipeline."""


@dataclasses.dataclass
class Shutdown(Request):
    """Clean stop over the wire: flush every in-flight batch, release
    the engine's kind stacks and compiled-program caches (``SDE.close``)
    and ack with final counters. The JSON-lines server stops serving
    after acking; a socket client gets a clean stop it could never
    signal via EOF without dropping the connection mid-response."""


@dataclasses.dataclass
class StatusReport(Request):
    pass


@dataclasses.dataclass
class Response:
    request_id: str
    synopsis_id: str = ""
    ok: bool = True
    value: Any = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    error: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=_jsonable)


def _jsonable(x):
    try:
        import numpy as np
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.generic,)):
            return x.item()
    except Exception:
        pass
    return str(x)


_KINDS = {
    "build": BuildSynopsis,
    "stop": StopSynopsis,
    "load": LoadSynopsis,
    "adhoc": AdHocQuery,
    "federated_query": FederatedQuery,
    "query_many": QueryMany,
    "ingest": Ingest,
    "build_multidim": BuildMultidim,
    "ingest_multidim": IngestMultidim,
    "subpop_query": SubpopQuery,
    "track_outliers": TrackOutliers,
    "untrack_outliers": UntrackOutliers,
    "flush": Flush,
    "shutdown": Shutdown,
    "status": StatusReport,
}

# Request types that mutate engine lifecycle state and must be
# write-ahead logged before they are applied (the WAL's replay set —
# ``service.wal`` re-exports this; ``ingest``/``ingest_multidim`` data
# is logged separately POST-apply, keyed by engine batch id).
MUTATING_REQUESTS = ("build", "stop", "load", "build_multidim",
                     "track_outliers", "untrack_outliers")


def parse_request(snippet: str | Dict[str, Any]) -> Request:
    """Parse a JSON request snippet into a typed request."""
    obj = json.loads(snippet) if isinstance(snippet, str) else dict(snippet)
    rtype = obj.pop("type")
    cls = _KINDS[rtype]
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(obj) - fields
    if unknown:
        raise ValueError(f"unknown fields for {rtype!r}: {sorted(unknown)}")
    return cls(**obj)
