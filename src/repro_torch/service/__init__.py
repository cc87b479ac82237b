"""SDE-as-a-Service (port of ``repro/service``): the engine, its JSON
API and the continuous response log. The gateway, WAL, migration,
balancer, planner and reconciler wait for later slices.
"""
from .api import (Request, Response, parse_request, BuildSynopsis,
                  StopSynopsis, AdHocQuery, QueryMany, Ingest, Flush,
                  Shutdown, StatusReport)
from .engine import SDE
from .pipeline import BoundedResponseLog, PendingBatch

__all__ = ["Request", "Response", "parse_request", "BuildSynopsis",
           "StopSynopsis", "AdHocQuery", "QueryMany", "Ingest", "Flush",
           "Shutdown", "StatusReport", "SDE", "BoundedResponseLog",
           "PendingBatch"]
