"""Sticky Sampling [Manku & Motwani 2002] -- probabilistic frequent items
(port of ``repro/core/sticky.py``).

As in the reference: a table of ``capacity`` slots (288 at the default
support, eps and delta); a tuple that arrives when the row has seen
``n - 1`` tuples first checks the epoch its count asks for,

    want_epoch(n) = max(0, floor(log2(max(float32(n) / t, 1))))

with t = 16 * capacity; where that is above the row's epoch (a "bump"),
every slot j loses floor(log(max(u_j, 1e-9)) / log(0.5)) of its count
(u_j = uniform01(j ^ n, seed), at least 0) and a slot whose count falls
to 0 or below is emptied, and the epoch becomes want_epoch(n). Then the
tuple's item adds one to its slot if it is tracked, else takes the first
empty slot with probability 2**-epoch (coin ``uniform01(item ^ n,
seed + 1)``). A masked step of the reference still takes the bump check
(only the count and the slot write are masked), which matters to a
stacked update; see :func:`walk_row`.

State is four leaves: ``keys`` ``[capacity]`` int32 (the uint32 item
identities as int32 bit patterns; the empty sentinel 0xFFFFFFFF is
``-1``), ``counts`` ``[capacity]`` float32, ``n_seen`` and ``epoch``
int32 scalars. The sentinel's literal semantics are kept: an item whose
bits are 0xFFFFFFFF "hits" every empty slot, so its count goes into the
first empty slot and that slot's key stays empty; a later admission into
the first empty slot adds to that count.

The two float functions, ``want_epoch`` and ``geo``, are kept literally
(:func:`want_epoch`, :func:`geo`, evaluated in float32 by torch on the
CPU), and both are monotone step functions: of n, and of the uint32 hash
h whose ``uniform01`` is u. So the walk and the kernel read them from
integer tables of where each step begins (:func:`epoch_starts`,
:func:`geo_steps`), built from the literal functions: the card then
computes what the CPU computes without calling its own ``log2``/``log``.
The admission limit 1 / exp2(epoch) is a table of floats too
(:func:`inv_rates`).

Differences from the reference:

  * ``add_batch`` updates ``state`` in place. It takes every tuple of the
    batch as the reference's scan does, masked ones included
    (:func:`step_row`, the reference's ``_step`` literally).
  * There is no ``stacked_add_batch``: the engine updates a stack through
    the registry kernel ``"sticky_scan"`` (``kernels/ops.py``, the
    routing probe fused in unless ``SDE_FUSED_PROBE`` is off), and
    ``batched.stacked_update`` through :meth:`StickySampling.scan_update`;
    both group the batch by row (the hand-written kernel of
    ``kernels/sticky_scan.py`` on the card), where the reference vmaps
    ``add_batch`` over every row with the whole batch masked. The rows'
    bumps fall where the reference's fall (:func:`walk_row`).
  * ``merge`` sorts with ``torch.argsort(stable=True)``, as
    ``jnp.argsort`` is stable.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math

import numpy as np
import torch

from . import hashing

EMPTY = -1      # int32 bits of the reference's uint32 sentinel 0xFFFFFFFF
NEVER = 2**31   # past every int32 count: an epoch no count reaches
MAX_RATE_EPOCH = 128    # exp2(128.0) is inf in float32: 1 / it is 0 above
_U_SCALE = np.float32(1.0 / 4294967296.0)    # uniform01's 2**-32
# each table's search windows: counts around t * 2**k, hashes around 2**e
_EPOCH_WINDOW = 1 << 16
_GEO_WINDOW = 128


def want_epoch(n: torch.Tensor, t: int) -> torch.Tensor:
    """The epoch count ``n`` asks for, literally the reference's float32
    expression: int32 of max(0, floor(log2(max(float32(n) / t, 1))))."""
    x = torch.clamp(n.to(torch.float32) / t, min=1.0)
    return torch.clamp(torch.floor(torch.log2(x)), min=0.0).to(torch.int32)


def geo(u: torch.Tensor) -> torch.Tensor:
    """The decrement of a slot whose draw is ``u`` (float32), literally
    the reference's: floor(log(max(u, 1e-9)) / log(0.5)), float32."""
    return torch.floor(torch.log(torch.clamp(u, min=1e-9)) / math.log(0.5))


def geo_of_hash(h: torch.Tensor) -> torch.Tensor:
    """:func:`geo` of ``uniform01``'s float of the uint32 hash ``h``
    (int64 values in [0, 2**32))."""
    return geo(h.to(torch.float32) * _U_SCALE)


@functools.lru_cache(maxsize=None)
def epoch_starts(t: int) -> tuple:
    """``starts[k - 1]``: the least count n in [1, 2**31) with
    ``want_epoch(n, t) >= k``, for k = 1, 2, ... while some count reaches
    epoch k. Each start is searched for in a window of counts around
    t * 2**k, evaluated by :func:`want_epoch` on the CPU; a window that
    does not rise from below k to k at one place raises."""
    starts = []
    k = 1
    while t * 2**k - _EPOCH_WINDOW < NEVER:
        c = t * 2**k
        lo, hi = max(1, c - _EPOCH_WINDOW), min(NEVER - 1, c + _EPOCH_WINDOW)
        n = torch.arange(lo, hi + 1, dtype=torch.int64)
        w = want_epoch(n, t).to(torch.int64)
        if bool((w[1:] < w[:-1]).any()) or int(w[0]) >= k:
            raise RuntimeError(f"want_epoch is not a step at {k} near {c}")
        above = torch.nonzero(w >= k)[:, 0]
        if above.numel() == 0:
            if hi < NEVER - 1:
                raise RuntimeError(f"want_epoch does not reach {k} by {hi}")
            break
        starts.append(lo + int(above[0]))
        k += 1
    return tuple(starts)


@functools.lru_cache(maxsize=None)
def geo_steps() -> tuple:
    """(thresholds, values): ``geo_of_hash(h)`` is ``values[i]`` for the
    number i of thresholds <= h (ascending uint32 hashes; values float32,
    one more than the thresholds). Every hash below 4,096 and the hashes
    around each power of two from 2**12 to 2**32 (as far as 128 distinct
    floats) are evaluated on the CPU; geo is monotone in h, so two
    samples of one value hold it between them too. A step between
    samples of two values raises."""
    parts = [torch.arange(0, 4096, dtype=torch.int64)]
    for e in range(12, 33):
        w = _GEO_WINDOW << max(0, e - 24)
        parts.append(torch.arange(max(0, 2**e - w), min(2**e + w, 2**32),
                                  dtype=torch.int64))
    h = torch.unique(torch.cat(parts))
    bits = geo_of_hash(h).view(torch.int32)
    change = torch.nonzero(bits[1:] != bits[:-1])[:, 0] + 1
    if bool((h[change] - h[change - 1] != 1).any()):
        raise RuntimeError("geo steps between two sampled hashes")
    vals = torch.cat([bits[:1], bits[change]]).view(torch.float32)
    return tuple(h[change].tolist()), tuple(vals.tolist())


@functools.lru_cache(maxsize=None)
def inv_rates() -> tuple:
    """1 / exp2(float32(e)) in float32 for e = 0 .. MAX_RATE_EPOCH, the
    reference's admission limit at epoch e (0 from MAX_RATE_EPOCH on)."""
    e = torch.arange(MAX_RATE_EPOCH + 1, dtype=torch.float32)
    return tuple((1.0 / torch.exp2(e)).tolist())


def want_of(n: torch.Tensor, t: int) -> torch.Tensor:
    """:func:`want_epoch` from its table (int64; n any integer tensor)."""
    starts = torch.tensor(epoch_starts(t), dtype=torch.int64,
                          device=n.device)
    return torch.searchsorted(starts, n.to(torch.int64), right=True)


def geo_of(h: torch.Tensor) -> torch.Tensor:
    """:func:`geo_of_hash` from its table (float32; h int64 in
    [0, 2**32))."""
    at, vals = geo_steps()
    thr = torch.tensor(at, dtype=torch.int64, device=h.device)
    val = torch.tensor(vals, dtype=torch.float32, device=h.device)
    return val[torch.searchsorted(thr, h, right=True)]


def decrement(counts: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """counts - g, where below 0 then 0 (NaN stays NaN), float32."""
    d = counts - g
    return torch.where(d < 0, torch.zeros_like(d), d)


def _wrap32(x):
    """int64 values as the int32 they wrap to."""
    return ((x + 2**31) % 2**32) - 2**31


def bump_rows(kind, keys, counts, n_seen, epoch) -> None:
    """The bump check every row of a stack takes at a batch's first step
    (a step of the reference's scan, valid or masked), in place: rows
    whose ``want_epoch(n_seen + 1)`` is above their epoch take the
    decrement and empty the slots it brings to 0 or below, and their
    epoch becomes that. keys [n, cap] i32; counts [n, cap] f32; n_seen,
    epoch [n] i32."""
    n = _wrap32(n_seen.to(torch.int64) + 1)
    want = want_of(n, kind.capacity * 16)
    rows = torch.nonzero(want > epoch)[:, 0]
    if rows.numel() == 0:
        return
    j = torch.arange(keys.shape[1], dtype=torch.int64, device=keys.device)
    h = hashing.hash_u32(j[None, :] ^ hashing.as_u32(n[rows])[:, None],
                         kind.seed)
    c = decrement(counts[rows], geo_of(h))
    counts[rows] = c
    keys[rows] = torch.where(c <= 0, EMPTY, keys[rows])
    epoch[rows] = want[rows].to(torch.int32)


def _bump_np(kind, keys: np.ndarray, counts: np.ndarray, n: int) -> None:
    j = torch.arange(keys.shape[0], dtype=torch.int64)
    g = geo_of(hashing.hash_u32(j ^ (n & hashing.MASK32), kind.seed))
    c = decrement(torch.from_numpy(counts), g).numpy()
    counts[:] = c
    keys[c <= 0] = EMPTY


def _index(keys: np.ndarray):
    """(each tracked key's first slot, the empty slots as a heap)."""
    ks = keys.tolist()
    first = dict(zip(reversed(ks), range(len(ks) - 1, -1, -1)))
    first.pop(EMPTY, None)
    return first, np.flatnonzero(keys == EMPTY).tolist()


def walk_row(kind, keys: np.ndarray, counts: np.ndarray, n_seen: int,
             epoch: int, items: torch.Tensor, end_check: bool) -> tuple:
    """One row's own tuples (``items``, int32 bits, all valid) in batch
    order, after its batch-start bump check (:func:`bump_rows`); keys and
    counts (host numpy) in place. Returns (n_seen, epoch).

    Under the reference's vmap every row steps through the whole batch,
    masked to its tuples, and a masked step takes the bump check at the
    row's n_seen + 1 (only the count and the slot write are masked). A
    check at one count bumps at most once, and nothing but a bump changes
    a row between its tuples, so a row's steps come to: a check at the
    batch's first step, a check then a step for each of its tuples, and,
    where its last tuple is not the batch's last (``end_check``), the
    check the next step takes at the count after it. Where the last
    tuple is the batch's last, that check falls on the next batch's first
    step. Each tuple's coin and its epoch follow from its count alone
    (tuple i arrives at n_seen + i + 1), so they are computed for all at
    once; the lookups then go a tuple at a time."""
    t = kind.capacity * 16
    m = items.shape[0]
    n = _wrap32(n_seen + 1 + torch.arange(m + 1, dtype=torch.int64))
    want = want_of(n, t)
    ep = torch.clamp(torch.cummax(want, 0).values, min=epoch)
    before = torch.cat([torch.tensor([epoch]), ep[:-1]])
    bump = (want > before).tolist()
    x = hashing.as_u32(items)
    coin = hashing.uniform01(x ^ hashing.as_u32(n[:m]), kind.seed + 1)
    rates = torch.tensor(inv_rates(), dtype=torch.float32)
    admit = (coin < rates[torch.clamp(ep[:m], max=MAX_RATE_EPOCH)]).tolist()
    n_list, one = n.tolist(), np.float32(1.0)
    first, empties = _index(keys)
    for i, item in enumerate(items.tolist()):
        if bump[i]:
            _bump_np(kind, keys, counts, n_list[i])
            first, empties = _index(keys)
        if item == EMPTY:                   # hits the first empty slot
            j = empties[0] if empties else None
        else:
            j = first.get(item)
            if j is None and empties and admit[i]:
                j = heapq.heappop(empties)
                keys[j] = item
                first[item] = j
        if j is not None:
            counts[j] = counts[j] + one
    if m == 0:
        return n_seen, epoch
    if end_check and bump[m]:
        _bump_np(kind, keys, counts, n_list[m])
        return int(n[m - 1]), int(ep[m])
    return int(n[m - 1]), int(ep[m - 1])


def step_row(kind, state, item: torch.Tensor, valid: torch.Tensor) -> None:
    """The reference's ``_step`` literally, on one row's state in place:
    ``item`` an int32 scalar (uint32 bits), ``valid`` a bool scalar."""
    keys, counts = state["keys"], state["counts"]
    n = state["n_seen"] + 1
    want = want_epoch(n, kind.capacity * 16)
    bump = want > state["epoch"]
    j = torch.arange(kind.capacity, dtype=torch.int64, device=keys.device)
    g = geo(hashing.uniform01(j ^ hashing.as_u32(n), kind.seed))
    c = torch.where(bump, torch.clamp(counts - g, min=0.0), counts)
    k = torch.where(bump & (c <= 0), EMPTY, keys)
    hit = k == item
    empty = k == EMPTY
    any_hit, any_empty = hit.any(), empty.any()
    coin = hashing.uniform01(hashing.as_u32(item) ^ hashing.as_u32(n),
                             kind.seed + 1)
    epoch = torch.maximum(want, state["epoch"])
    admit = coin < 1.0 / torch.exp2(epoch.to(torch.float32))
    slot = torch.where(any_hit, hit.to(torch.uint8).argmax(),
                       empty.to(torch.uint8).argmax())
    do = valid & (any_hit | (any_empty & admit))
    k[slot] = torch.where(do, item, k[slot])
    c[slot] = torch.where(do, c[slot] + 1.0, c[slot])
    keys.copy_(k)
    counts.copy_(c)
    state["n_seen"].copy_(torch.where(valid, n, state["n_seen"]))
    state["epoch"].copy_(epoch)


@dataclasses.dataclass(frozen=True)
class StickySampling:
    support: float = 0.01
    eps: float = 0.002
    delta: float = 0.01
    seed: int = 37

    merge_mode = "gather"
    update_kernel = "sticky_scan"      # kernels.ops registry name

    @property
    def capacity(self) -> int:
        t = math.log(1.0 / (self.support * self.delta)) / self.eps
        return int(min(max(8, math.ceil(t / 16.0)), 4096))

    def init(self, device) -> dict:
        return dict(
            keys=torch.full((self.capacity,), EMPTY, dtype=torch.int32,
                            device=device),
            counts=torch.zeros((self.capacity,), dtype=torch.float32,
                               device=device),
            n_seen=torch.zeros((), dtype=torch.int32, device=device),
            epoch=torch.zeros((), dtype=torch.int32, device=device))

    def add_batch(self, state, items, values, mask) -> dict:
        """The reference's scan over every tuple, masked ones included
        (a plain loop of :func:`step_row`), in place."""
        del values
        for item, valid in zip(items, mask):
            step_row(self, state, item, valid)
        return state

    def scan_update(self, state, syn_idx, items, values, mask,
                    source_rows=None) -> dict:
        """Update a stack ``{keys, counts: [n, capacity], n_seen, epoch:
        [n]}`` in place, as the reference's vmap does: every row takes
        the batch's first bump check, row r the tuples with ``mask &
        (syn_idx == r)`` and a data-source row (``source_rows``) every
        tuple with ``mask``, each in batch order, with the bumps its masked
        steps take. The hand-written sticky-scan kernel on the card, its
        plain version on the CPU."""
        del values
        from repro_torch.kernels import sticky_scan     # kernels import core
        sticky_scan.sticky_scan_update(
            state["keys"], state["counts"], state["n_seen"], state["epoch"],
            syn_idx, items, mask, source_rows, **self.params())
        return state

    def params(self) -> dict:
        return dict(support=self.support, eps=self.eps, delta=self.delta,
                    seed=self.seed)

    def estimate(self, state, items) -> torch.Tensor:
        """Frequency estimates (0 when not tracked)."""
        eq = state["keys"][None, :] == items[:, None]
        return torch.where(eq, state["counts"][None, :], 0.0).sum(dim=-1)

    def stacked_estimate(self, state, rows, items) -> torch.Tensor:
        """Batched frequency queries: query q matches ``items[q]`` against
        the key table of row ``rows[q]`` -- [N, I] from one table gather."""
        r = rows.long()
        keys, counts = state["keys"][r], state["counts"][r]
        eq = keys[:, None, :] == items[:, :, None]
        return torch.where(eq, counts[:, None, :], 0.0).sum(dim=-1)

    def frequent_items(self, state):
        thr = (self.support - self.eps) * state["n_seen"].to(torch.float32)
        keep = state["counts"] >= torch.clamp(thr, min=1.0)
        return state["keys"], state["counts"], keep

    def merge(self, a, b) -> dict:
        """Approximate merge: the union of the tables, the highest counts
        kept."""
        keys = torch.cat([a["keys"], b["keys"]])
        counts = torch.cat([a["counts"], b["counts"]])
        order = torch.argsort(-counts, stable=True)[:self.capacity]
        return dict(keys=keys[order], counts=counts[order],
                    n_seen=a["n_seen"] + b["n_seen"],
                    epoch=torch.maximum(a["epoch"], b["epoch"]))

    def memory_bytes(self) -> int:
        return self.capacity * 8
