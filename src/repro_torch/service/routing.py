"""Hashed stream routing: arbitrary 63-bit stream ids -> kind-stack rows.

A copy of ``repro/service/routing.py``, kept in the port because importing
that module runs ``repro/service/__init__.py``, which imports JAX. The
code is the reference's numpy, unchanged, so the tables come out
identical slot for slot (``tests/test_torch_probe.py`` holds them equal).

A :class:`RouteTable` is an open-addressing hash table with linear
probing: pow2-sized ``keys``/``rows`` arrays, tombstone-free inserts on
build, full re-insert compaction on stop, and grow-and-rehash past
~``_MAX_LOAD`` load factor. Stream ids are arbitrary ints in
``[0, 2**63)``.

Split of responsibilities:

  * HOST (this module, numpy): the authoritative table. Inserts/removes
    happen on the rare lifecycle path (build/stop), so they are plain
    vectorized numpy.
  * DEVICE (``kernels.probe``): the per-batch lookup, a bounded linear
    probe over the table's device mirror, which stores keys as uint32
    lo/hi halves (int32 bit patterns). On the card it runs inside the
    CUDA kernels (``kernels/csrc/probe.cuh``).

The device probe runs at most ``n_probe`` steps, so the table tracks the
longest insertion displacement (``max_probe``) and grows whenever an
insert would displace past :data:`PROBE_CAP`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_MAX_LOAD = 0.7          # grow-and-rehash past this occupancy
PROBE_CAP = 32           # grow instead of probing longer than this
_MIN_SIZE = 64           # smallest table (pow2)
_GOLDEN = np.uint32(0x9E3779B9)

# host sentinel for an empty slot; its uint32 halves are both 0xFFFFFFFF,
# unreachable by valid ids (hi <= 0x7FFFFFFF for ids < 2**63) — the
# device probe detects empty slots from the hi half alone.
EMPTY = np.int64(-1)

MAX_STREAM_ID = (1 << 63) - 1


def _mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 on uint32 arrays — bit-identical to
    ``core.hashing.mix32`` (the device side of the probe)."""
    x = np.atleast_1d(np.asarray(x)).astype(np.uint32)  # uint32 wraps; the
    with np.errstate(over="ignore"):                    # scalar path warns
        x ^= x >> np.uint32(16)
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x ^= x >> np.uint32(13)
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        x ^= x >> np.uint32(16)
    return x


def split64(sids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 stream ids -> (lo, hi) uint32 halves."""
    s = np.asarray(sids, np.int64)
    lo = (s & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = ((s >> np.int64(32)) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    return lo, hi


def fold64(sids: np.ndarray) -> np.ndarray:
    """Fold a 64-bit stream id into the uint32 item identity the sketches
    hash. Identity for ids < 2**32 (``hi == 0``), so sketch contents are
    bit-identical to the pre-hashed-routing engine on small id spaces."""
    lo, hi = split64(sids)
    return (lo ^ (_mix32(hi) * _GOLDEN)).astype(np.uint32)


def slot_hash(lo: np.ndarray, hi: np.ndarray, size: int) -> np.ndarray:
    """Initial probe slot for keys given as uint32 halves. Must stay in
    lockstep with ``kernels.probe.slot0`` and ``csrc/probe.cuh``."""
    h = _mix32(lo.astype(np.uint32) ^ _mix32(hi.astype(np.uint32)
                                             ^ _GOLDEN))
    return (h & np.uint32(size - 1)).astype(np.int64)


class RouteTable:
    """Host-side open-addressing stream->row map (linear probing)."""

    def __init__(self, size: int = _MIN_SIZE):
        size = max(_MIN_SIZE, next_pow2(size))
        self.keys = np.full((size,), EMPTY, np.int64)
        self.rows = np.full((size,), -1, np.int32)
        self.count = 0
        self.max_probe = 1      # longest insert displacement + 1
        self.version = 0        # bumped on any mutation (device cache key)

    # -- read ----------------------------------------------------------
    @property
    def size(self) -> int:
        return int(self.keys.shape[0])

    @property
    def load(self) -> float:
        return self.count / self.size

    def lookup(self, sid: int) -> int:
        """Row for ``sid`` or -1 (host-side twin of the device probe)."""
        sid = int(sid)
        slot = int(slot_hash(*split64(np.int64(sid)), self.size).ravel()[0])
        mask = self.size - 1
        for _ in range(self.max_probe):
            k = self.keys[slot]
            if k == sid:
                return int(self.rows[slot])
            if k == EMPTY:
                return -1
            slot = (slot + 1) & mask
        return -1

    def lookup_many(self, sids: np.ndarray) -> np.ndarray:
        """Vectorized ``lookup``: int32 rows, -1 where a key is absent —
        the same probe rounds as ``_contains_many``, returning the row
        instead of a membership bit. The dirty-tracking resolver runs a
        whole ingest window of stream ids through this in a handful of
        numpy passes."""
        sids = np.asarray(sids, np.int64).ravel()
        out = np.full(sids.shape, -1, np.int32)
        if sids.size == 0 or self.count == 0:
            return out
        slot = slot_hash(*split64(sids), self.size)
        mask = self.size - 1
        active = np.ones(sids.shape, bool)
        for _ in range(self.max_probe):
            k = self.keys[slot]
            hit = active & (k == sids)
            out[hit] = self.rows[slot[hit]]
            active &= ~hit & (k != EMPTY)
            if not active.any():
                break
            slot = (slot + 1) & mask
        return out

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(stream_ids, rows) of every occupied slot."""
        occ = self.keys != EMPTY
        return self.keys[occ].copy(), self.rows[occ].copy()

    # -- write ---------------------------------------------------------
    def insert(self, sid: int, row: int) -> None:
        self.insert_many([sid], [row])

    def insert_many(self, sids: np.ndarray, rows: np.ndarray) -> None:
        """Bulk insert (vectorized rounds of probing — a 1M-stream build
        is a handful of numpy passes, not 1M Python probes). Re-inserting
        an existing key updates its row."""
        try:
            sids = np.asarray(sids, np.int64)
        except OverflowError as e:
            raise ValueError(
                "stream id outside [0, 2**63) — ids must be non-negative "
                "63-bit ints") from e
        rows = np.asarray(rows, np.int32)
        if sids.size == 0:
            return
        if sids.size > 1:
            # intra-batch duplicates: LAST occurrence wins, matching the
            # sequential-insert semantics (a tie-losing duplicate must
            # not land in a second slot and orphan a row mapping)
            _, idx = np.unique(sids[::-1], return_index=True)
            keep = np.sort(sids.size - 1 - idx)
            sids, rows = sids[keep], rows[keep]
        if np.any((sids < 0) | (sids > MAX_STREAM_ID)):
            bad = sids[(sids < 0) | (sids > MAX_STREAM_ID)][0]
            raise ValueError(
                f"stream id {int(bad)} outside [0, 2**63) — ids must be "
                "non-negative 63-bit ints")
        # reserve for genuinely NEW keys only: re-inserts (row updates)
        # must not count toward load or trigger a pointless grow
        fresh = int(np.count_nonzero(~self._contains_many(sids)))
        self._reserve(self.count + fresh)
        self._insert_rounds(sids, rows)
        self.version += 1

    def remap_rows(self, old_rows: np.ndarray, new_rows: np.ndarray) -> None:
        """Atomically rewrite row targets: every key routed to
        ``old_rows[i]`` now routes to ``new_rows[i]``. Keys never move —
        slot layout, ``count`` and ``max_probe`` are untouched, so the
        fused probe programs need no retrace — and the single version
        bump republishes the device mirror in one step (the migration
        plane's routing commit: a reader sees the old mapping or the new
        one, never a half-moved table)."""
        old = np.asarray(old_rows, np.int32)
        new = np.asarray(new_rows, np.int32)
        if old.shape != new.shape:
            raise ValueError(
                f"remap_rows: {old.size} old rows vs {new.size} new rows")
        if old.size == 0:
            return
        top = int(max(old.max(), new.max(), self.rows.max(initial=0)))
        rowmap = np.arange(top + 1, dtype=np.int32)
        rowmap[old] = new
        occ = self.rows >= 0
        self.rows[occ] = rowmap[self.rows[occ]]
        self.version += 1

    def remove_rows(self, dead_rows: np.ndarray) -> None:
        """Drop every key routed to ``dead_rows`` and compact by full
        re-insert (tombstone-free: stop is the rare path, and rebuilding
        keeps probe chains at their insert-time bound)."""
        dead = np.asarray(dead_rows, np.int32)
        keys, rows = self.items()
        keep = ~np.isin(rows, dead)
        if keep.all():
            # nothing routed to the dead rows (e.g. a source-only stop):
            # skip the rebuild and the device-mirror re-upload
            return
        self._rebuild(keys[keep], rows[keep], self.size)
        self.version += 1

    # -- internals -----------------------------------------------------
    def _contains_many(self, sids: np.ndarray) -> np.ndarray:
        """Vectorized membership test (the batched twin of ``lookup``)."""
        slot = slot_hash(*split64(sids), self.size)
        mask = self.size - 1
        found = np.zeros(sids.shape, bool)
        active = np.ones(sids.shape, bool)
        for _ in range(self.max_probe):
            k = self.keys[slot]
            hit = active & (k == sids)
            found |= hit
            active &= ~hit & (k != EMPTY)
            if not active.any():
                break
            slot = (slot + 1) & mask
        return found

    def _reserve(self, want_count: int) -> None:
        size = self.size
        while want_count > _MAX_LOAD * size:
            size *= 2
        if size != self.size:
            keys, rows = self.items()
            self._rebuild(keys, rows, size)

    def _rebuild(self, keys: np.ndarray, rows: np.ndarray,
                 size: int) -> None:
        size = max(_MIN_SIZE, next_pow2(size))
        self.keys = np.full((size,), EMPTY, np.int64)
        self.rows = np.full((size,), -1, np.int32)
        self.count = 0
        self.max_probe = 1
        if keys.size:
            self._insert_rounds(keys, rows)

    def _insert_rounds(self, sids: np.ndarray, rows: np.ndarray) -> None:
        """Vectorized linear-probe insertion. Each round places every
        pending key that (a) found an empty slot and (b) won the
        first-come tie-break for it; losers advance one slot. Grows and
        restarts if any key would displace past PROBE_CAP."""
        mask = self.size - 1
        slot = slot_hash(*split64(sids), self.size)
        pending = np.arange(sids.size)
        for dist in range(PROBE_CAP):
            k_at = self.keys[slot]
            dup = k_at == sids[pending]            # key already present
            if np.any(dup):
                self.rows[slot[dup]] = rows[pending[dup]]
                keepm = ~dup
                pending, slot = pending[keepm], slot[keepm]
                k_at = k_at[keepm]
            if pending.size == 0:
                return
            empty = k_at == EMPTY
            # first occurrence wins each contested empty slot this round
            place = np.zeros(pending.size, bool)
            if np.any(empty):
                cand = np.nonzero(empty)[0]
                _, first = np.unique(slot[cand], return_index=True)
                place[cand[first]] = True
                tgt = slot[place]
                self.keys[tgt] = sids[pending[place]]
                self.rows[tgt] = rows[pending[place]]
                self.count += tgt.size
                self.max_probe = max(self.max_probe, dist + 1)
            pending, slot = pending[~place], slot[~place]
            if pending.size == 0:
                return
            slot = (slot + 1) & mask
        # someone would probe past the cap: grow and re-insert the rest
        # (rebuild re-inserts the already-placed keys at the new size)
        keys_done, rows_done = self.items()
        self._rebuild(np.concatenate([keys_done, sids[pending]]),
                      np.concatenate([rows_done, rows[pending]]),
                      self.size * 2)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())
