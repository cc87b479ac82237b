"""Continuous-query emission (port of ``BoundedResponseLog`` and
``PendingBatch`` from ``repro/service/pipeline.py``).

In this slice continuous queries run EAGER: the engine materializes each
batch's ``PendingBatch`` right after dispatching it. The reference's
bounded ``IngestPipeline`` (deferred materialization) waits for a later
slice.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, List, Optional, Tuple


class BoundedResponseLog(collections.deque):
    """A bounded response sink (the engine's ``continuous_out``): when
    full, appending evicts the oldest response and counts it in
    ``dropped``, so a consumer that falls behind loses the oldest results,
    never the newest."""

    def __init__(self, cap: Optional[int] = 65536):
        super().__init__(maxlen=cap if cap and cap > 0 else None)
        self.dropped = 0

    def append(self, response) -> None:
        if self.maxlen is not None and len(self) == self.maxlen:
            self.dropped += 1        # deque(maxlen) evicts from the left
        super().append(response)

    def drain(self) -> List[Any]:
        """Pop EVERY unread response, oldest first."""
        out = []
        while self:
            out.append(self.popleft())
        return out


@dataclasses.dataclass
class PendingBatch:
    """One ingest batch's continuous emission: ``(ids, take, out)`` per
    kind -- the continuous synopsis ids, the per-query result slicer from
    ``_plan_queries`` and the ``estimate_all`` output."""
    batch_id: int
    emissions: List[Tuple[List[str], Callable[..., Any], Any]]
