"""Lossy Counting in the port against the JAX package: the kind
(``core/lossy.py``) at eps 0.05, 0.03 and 0.01 (k = 20, 34 and 100), its
queries and merge, the stacked scan (``batched.stacked_update``'s scan
branch, whose CPU route is the scan kernel's plain version) against the
reference's vmap, and the engine's JSON flow through ``SDE.handle`` in
both packages, then carried across by ``convert.engine_from_contents``.

Everything agrees byte for byte: ``keys`` compared as uint32 bits,
``counts`` and ``error`` as float32 bytes, for integer and float weights
alike (each count is one float32 add a step, in the same order)."""
import collections

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.core import lossy as jlossy
from repro.service import SDE as JaxSDE
from test_torch_convert import jax_contents
from test_torch_cuda import LOSSY_PATTERNS, _lossy_case, _lossy_pattern
from test_torch_rhp import _same
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.core import lossy as tlossy
from repro_torch.kernels import lossy_scan, ref
from repro_torch.kernels import ops as tops
from repro_torch.service import SDE as TorchSDE

SENTINEL = 0xFFFFFFFF
EPS = [0.05, 0.03, 0.01]                     # k = 20, 34, 100


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _same_state(got, want):
    """A port state (dict of tensors, int32 keys) byte-equal to a JAX
    state (uint32 keys)."""
    assert sorted(got) == sorted(want) == ["counts", "error", "keys"]
    for name in ("keys", "counts", "error"):
        w = np.asarray(want[name])
        g = got[name].numpy()
        if name == "keys":
            assert w.dtype == np.uint32 and g.dtype == np.int32
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _items(rng, t, sentinel=True):
    """Zipf item ids (uint32) with a few ids near 2**32 and, where asked,
    the sentinel 0xFFFFFFFF among them."""
    items = (rng.zipf(1.3, t) % 5000).astype(np.uint32)
    items[::37] = np.uint32(SENTINEL - 3)
    if sentinel:
        items[5::41] = np.uint32(SENTINEL)
    return items


def _weights(rng, t, float_weights):
    return (rng.randn(t) * 3 if float_weights
            else rng.randint(1, 5, t)).astype(np.float32)


def _jstate(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


@pytest.mark.smoke
def test_sentinel_item_fills_the_first_empty_slot_and_stays_empty():
    """An item whose bits are the sentinel "hits" every empty slot: its
    weight goes into the first one, whose key stays empty; the next real
    item then takes that slot as empty, keeping its count at 0 + v."""
    jk, tk = jlossy.LossyCounting(eps=0.25), tlossy.LossyCounting(eps=0.25)
    items = np.asarray([7, SENTINEL, SENTINEL, 9, 7], np.uint32)
    vals = np.asarray([1, 2, 4, 8, 16], np.float32)
    mask = np.ones(5, bool)
    js = jk.add_batch(jk.init(), jnp.asarray(items), jnp.asarray(vals),
                      jnp.asarray(mask))
    ts = tk.add_batch(tk.init("cpu"), _t(items), _t(vals), _t(mask))
    _same_state(ts, js)
    assert ts["keys"].tolist() == [7, 9, -1, -1]
    assert ts["counts"].tolist() == [17.0, 8.0, 0.0, 0.0]


@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("eps", EPS)
def test_add_batch_matches_jax(eps, float_weights):
    """The one-row scan over Zipf items with masked tuples, ids near 2**32
    and the sentinel, from an empty table and then from the table it
    left (evictions throughout: far more distinct items than slots)."""
    jk, tk = jlossy.LossyCounting(eps=eps), tlossy.LossyCounting(eps=eps)
    assert tk.k == jk.k == {0.05: 20, 0.03: 34, 0.01: 100}[eps]
    assert tk.memory_bytes() == jk.memory_bytes()
    rng = np.random.RandomState(int(eps * 1000))
    js, ts = jk.init(), tk.init("cpu")
    _same_state(ts, js)
    for _ in range(2):
        t = 700
        items = _items(rng, t)
        vals = _weights(rng, t, float_weights)
        mask = rng.rand(t) > 0.15
        js = jk.add_batch(js, jnp.asarray(items), jnp.asarray(vals),
                          jnp.asarray(mask))
        assert tk.add_batch(ts, _t(items), _t(vals), _t(mask)) is ts
        _same_state(ts, js)
    assert int((np.asarray(js["error"]) != 0).sum()) > 0    # evictions


@pytest.mark.parametrize("eps", EPS)
def test_queries_and_merge_match_jax(eps):
    """``estimate`` (tracked, untracked and the sentinel), the stacked
    estimate of [N, I] queries, ``frequent_items`` and ``merge`` of two
    tables that share keys, each on the reference's own states."""
    jk, tk = jlossy.LossyCounting(eps=eps), tlossy.LossyCounting(eps=eps)
    rng = np.random.RandomState(7)
    states = []
    for _ in range(3):
        s = jk.init()
        items = _items(rng, 400, sentinel=False)
        s = jk.add_batch(s, jnp.asarray(items),
                         jnp.asarray(_weights(rng, 400, True)),
                         jnp.asarray(rng.rand(400) > 0.1))
        states.append({k: np.asarray(v) for k, v in s.items()})
    # a table holding the sentinel's weight in an empty slot
    states.append({k: np.asarray(v) for k, v in jk.add_batch(
        jk.init(), jnp.asarray(np.asarray([3, SENTINEL], np.uint32)),
        jnp.asarray(np.asarray([2.5, 4.0], np.float32)),
        jnp.ones(2, bool)).items()})
    t_states = [{k: _t(v) for k, v in s.items()} for s in states]
    q = np.concatenate([states[0]["keys"][:9],
                        np.asarray([123456789, SENTINEL], np.uint32)])
    for js, ts in zip(states, t_states):
        got = tk.estimate(ts, _t(q)).numpy()
        want = np.asarray(jk.estimate(_jstate(js), jnp.asarray(q)))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for min_count in (0.0, 3.5):
            g = tk.frequent_items(ts, min_count)
            w = jk.frequent_items(_jstate(js), min_count)
            assert g[0].numpy().view(np.uint32).tobytes() == \
                np.asarray(w[0]).tobytes()
            assert g[1].numpy().tobytes() == np.asarray(w[1]).tobytes()
            assert np.array_equal(g[2].numpy(), np.asarray(w[2]))
    stack = {k: np.stack([s[k] for s in states]) for k in states[0]}
    rows = np.asarray([2, 0, 3, 2, 1], np.int32)
    qs = np.stack([np.roll(q, i) for i in range(len(rows))])
    got = tk.stacked_estimate({k: _t(v) for k, v in stack.items()},
                              _t(rows), _t(qs)).numpy()
    want = np.asarray(jk.stacked_estimate(_jstate(stack), jnp.asarray(rows),
                                          jnp.asarray(qs)))
    assert got.shape == (5, len(q)) and got.tobytes() == want.tobytes()
    for a, b in ((0, 1), (1, 2), (3, 0), (2, 2)):
        _same_state(tk.merge(t_states[a], t_states[b]),
                    jk.merge(_jstate(states[a]), _jstate(states[b])))


def _scan_inputs(seed, n, t, float_weights):
    rng = np.random.RandomState(seed)
    syn = rng.randint(0, n - 3, t).astype(np.int32)   # rows n-3.. untouched
    syn[::4] = 2                                       # a long run
    syn[::7] = -1                                      # unrouted
    syn[3::29] = 5                                     # routed to a source
    return dict(syn=syn, items=_items(rng, t),
                vals=_weights(rng, t, float_weights),
                mask=rng.rand(t) > 0.2)


@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("sources", [None, [5], [5, 11, 5]],
                         ids=["no_source", "one_source", "repeated_source"])
@pytest.mark.parametrize("eps", [0.05, 0.03])
def test_stacked_scan_matches_jax_vmap(eps, sources, float_weights):
    """``batched.stacked_update``'s scan branch (the kernel wrapper's plain
    version on the CPU) against the reference's vmap of ``add_batch``:
    rows -1, repeated rows, a run of a quarter of the batch, untouched
    rows, data-source rows (one of them also routed to, one listed twice)
    over two batches; and ``ref.lossy_scan_update`` called directly."""
    jk = jcore.make_kind("lossy_counting", eps=eps)
    tk = tcore.make_kind("lossy_counting", eps=eps)
    n = 16
    jstate = jbatched.stacked_init(jk, n)
    tstate = tbatched.stacked_init(tk, n, "cpu")
    direct = tbatched.stacked_init(tk, n, "cpu")
    src = None if sources is None else np.asarray(sources, np.int32)
    before = lossy_scan.lossy_scan_update.launches
    for b in range(2):
        x = _scan_inputs(b + int(eps * 100), n, 500, float_weights)
        jstate = jbatched.stacked_update(
            jk, jstate, jnp.asarray(x["syn"]), jnp.asarray(x["items"]),
            jnp.asarray(x["vals"]), jnp.asarray(x["mask"]),
            None if src is None else jnp.asarray(src))
        args = (_t(x["syn"]), _t(x["items"]), _t(x["vals"]), _t(x["mask"]),
                None if src is None else _t(src).long())
        assert tbatched.stacked_update(tk, tstate, *args) is tstate
        ref.lossy_scan_update(direct["keys"], direct["counts"],
                              direct["error"], *args)
        _same_state(tstate, jstate)
        _same_state(direct, jstate)
    assert lossy_scan.lossy_scan_update.launches == before   # plain on CPU
    empty = {k: np.asarray(v)[None] for k, v in jk.init().items()}
    for r in range(n - 3, n):
        _same_state({k: v[r:r + 1] for k, v in tstate.items()}, empty)


def test_walks_of_counts_rows_and_the_longest_chain():
    """``lossy_scan.walks_of``: the routed rows with a masked-in tuple plus
    the distinct in-range source rows, and the longest walk (a source
    row's: every masked-in tuple)."""
    syn = torch.tensor([0, 0, 1, -1, 3, 3, 3, 9, 1], dtype=torch.int32)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    assert lossy_scan.walks_of(syn, mask, 4) == (3, 2)
    assert lossy_scan.walks_of(syn, mask, 4, torch.tensor([3, 3, 7])) == \
        (3, 7)
    assert lossy_scan.walks_of(syn, ~mask, 4) == (2, 1)


_NONE = 1 << 30


def _order_key(c: np.float32) -> int:
    """csrc/lossy_scan.cu's order key of a count: -0 as +0, NaN least."""
    if c != c:
        return 0
    u = int(np.float32(c).view(np.uint32))
    u = 0 if u == 0x80000000 else u
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


class _GroupWalk:
    """A test-only model of the order of operations of the scan kernel's
    group walk (``csrc/lossy_scan.cu``, ``GroupWalker``) on one table:
    32 tuples a group, every lane's slot looked up at once; then, while
    the table has an empty slot or the next tuple cannot open a phase, the
    hits before the first miss (in lane order) and that one miss, the
    lanes after it fixed for the one slot that changed; else a phase: the
    longest prefix whose misses take the slots of least count (``mins``)
    in slot order, all at once, and whose hits avoid the slots those
    misses take. ``mins`` is always empty or exactly the slots of least
    order key (-0 as +0, NaN least), as in the kernel. Counts every path
    it takes."""

    def __init__(self, keys, counts, error):
        self.keys, self.counts, self.error = keys, counts, error
        self.mins = set()
        self.paths = collections.Counter()

    def first(self, x):
        at = np.flatnonzero(self.keys == x)
        return int(at[0]) if at.size else _NONE

    def recompute(self):
        order = [_order_key(c) for c in self.counts]
        self.mins = {j for j, o in enumerate(order) if o == min(order)}
        self.paths["recompute"] += 1

    def rose(self, s, up):
        self.mins = self.mins - {s} if up else set()

    def add(self, s, v):
        a = self.counts[s]
        self.counts[s] = np.float32(a + v)
        return bool(self.counts[s] > a)

    def group(self, xs, vs):
        hit = [self.first(x) for x in xs]
        rem = list(range(len(xs)))
        while rem:
            if self.first(tlossy.EMPTY) != _NONE or \
                    not self.phase(rem, hit, xs, vs):
                self.one_miss(rem, hit, xs, vs)

    def one_miss(self, rem, hit, xs, vs):
        self.paths["one_miss"] += 1
        misses = [i for i in rem if hit[i] == _NONE]
        seg = [i for i in rem if not misses or i < misses[0]]
        if seg:
            slots = {hit[i] for i in seg}
            least = bool(slots & self.mins)
            up = all([self.add(hit[i], vs[i]) for i in seg])
            if len(slots) == 1:
                self.rose(hit[seg[0]], up)
            elif least or not up:
                self.mins = set()
        if not misses:
            rem.clear()
            return
        b = misses[0]
        rem[:] = [i for i in rem if i > b]
        x, v = xs[b], vs[b]
        s = self.first(tlossy.EMPTY)
        if s != _NONE:
            y = tlossy.EMPTY
            self.keys[s], self.counts[s] = x, np.float32(np.float32(0) + v)
            self.mins = set()
        else:
            if not self.mins:
                self.recompute()
            s = min(self.mins)
            y, old = int(self.keys[s]), self.counts[s]
            self.keys[s], self.error[s] = x, old
            self.rose(s, self.add(s, v))
            self.paths["sentinel eviction"] += x == tlossy.EMPTY
        for i in rem:
            if xs[i] == x:
                hit[i] = min(hit[i], s)
                self.paths["new key hit"] += 1
            elif xs[i] == y and hit[i] == s:
                hit[i] = self.first(y)
                self.paths["looked again"] += 1

    def phase(self, rem, hit, xs, vs):
        missm = [i for i in rem if hit[i] == _NONE]
        if missm and not self.mins:
            self.recompute()
        P = []
        for i in rem:
            if hit[i] == _NONE:
                earlier = [j for j in missm if j < i]
                stop = (any(xs[j] == xs[i] for j in earlier)
                        or not vs[i] > 0 or xs[i] == tlossy.EMPTY
                        or len(earlier) >= len(self.mins))
            else:
                stop = not vs[i] > 0
            if stop:
                break
            P.append(i)
        least = sorted(self.mins)
        pm = [i for i in P if hit[i] == _NONE]
        # a hit on a slot of least count that a miss of P would take ends
        # P; one beyond the misses' reach only raises its count
        cut = next((i for i in P if hit[i] in self.mins
                    and least.index(hit[i]) < len(pm)), None)
        if cut is not None:
            P = P[:P.index(cut)]
            pm = [i for i in P if hit[i] == _NONE]
        if not P:
            return False
        order = least[:len(pm)]
        bad = next((j for j, (i, s) in enumerate(zip(pm, order))
                    if not np.float32(self.counts[s] + vs[i])
                    > self.counts[s]), None)
        if bad is not None:
            P = [i for i in P if i <= pm[bad]]
            pm, order = pm[:bad + 1], order[:bad + 1]
            self.paths["phase cut at a count that did not rise"] += 1
        taken = dict(zip(pm, order))
        for i, s in taken.items():
            self.keys[s], self.error[s] = xs[i], self.counts[s]
            self.add(s, vs[i])
        raised = {hit[i] for i in P if hit[i] in self.mins}
        before = {s: self.counts[s] for s in raised}
        for i in P:
            if hit[i] != _NONE:
                self.add(hit[i], vs[i])
        self.mins = self.mins - set(order) - raised
        if bad is not None or any(not self.counts[s] > c
                                  for s, c in before.items()):
            self.mins = set()
        self.paths["hit on a slot of least count in a phase"] += bool(raised)
        del rem[:len(P)]
        for i in rem:
            same = [j for j in pm if xs[j] == xs[i]]
            if same:
                hit[i] = taken[same[0]]
                self.paths["new key hit"] += 1
            elif hit[i] in taken.values():
                hit[i] = self.first(xs[i])
                self.paths["looked again"] += 1
        self.paths["phase"] += 1
        self.paths["phase of 2+ misses"] += len(pm) > 1
        return True


def _model_scan(state, batch):
    """The stacked scan through ``_GroupWalk``, each walk as the kernel
    groups it: a routed row's tuples 32 at a time from the run's start, a
    data-source row's every 32 batch positions (the masked-in ones).
    Returns the stack (numpy) and the paths taken."""
    keys, counts, error = (x.numpy().copy() for x in state)
    rows, items, vals, mask, src = (
        None if x is None else x.numpy() for x in batch)
    n = keys.shape[0]
    srcs = sorted({int(r) for r in ([] if src is None else src)
                   if 0 <= r < n})
    paths = collections.Counter()
    for r in range(n):
        walk = _GroupWalk(keys[r], counts[r], error[r])
        if r in srcs:
            groups = [np.nonzero(mask[g:g + 32])[0] + g
                      for g in range(0, len(rows), 32)]
        else:
            mine = np.nonzero(mask & (rows == r))[0]
            groups = [mine[g:g + 32] for g in range(0, len(mine), 32)]
        for g in groups:
            if g.size:
                walk.group([int(x) for x in items[g]],
                           [np.float32(v) for v in vals[g]])
        paths.update(walk.paths)
    return (keys, counts, error), paths


def _want_scan(state, batch):
    """Each walked row through ``core/lossy.scan_row``, the reference's
    step literally, in batch order."""
    keys, counts, error = (x.clone() for x in state)
    rows, items, vals, mask, src = batch
    n = keys.shape[0]
    srcs = {int(r) for r in ([] if src is None else src.tolist())
            if 0 <= r < n}
    for r in range(n):
        take = mask if r in srcs else mask & (rows == r)
        tlossy.scan_row(keys[r], counts[r], error[r], items[take],
                        vals[take])
    return keys, counts, error


# the path each adversarial pattern is there to take
_PATTERN_PATH = {"reinsert": "new key hit", "evict_return": "looked again",
                 "all_miss_ties": "phase of 2+ misses",
                 "special_weights": "phase cut at a count that did not rise",
                 "sentinel_bursts": "sentinel eviction"}


@pytest.mark.parametrize("k", [4, 20, 100, 129])
@pytest.mark.parametrize("pattern", [None, *LOSSY_PATTERNS, "phase3"])
def test_group_walk_order_matches_scan_row(pattern, k):
    """The scan kernel's new order of operations (``_GroupWalk``: lookups
    of a group at once, the hits before a miss in lane order, a miss at a
    time with the one-slot fix-up, and phases of misses taking the slots
    of least count at once) byte for byte against ``core/lossy.scan_row``
    on the CPU: the card tests' ``_lossy_case`` stacks (keys repeated in
    a row, float weights, the sentinel, source rows) and
    ``_lossy_pattern``'s groups (an item inserted and hit again within 32
    tuples, evicted items back within 32, all-miss groups on tied counts,
    -0.0 / NaN / negative weights and counts, sentinel bursts, phase 3's
    traffic from an empty table); each pattern takes the path it is there
    for."""
    rng = np.random.RandomState(k)
    for float_weights in (False, True):
        if pattern is None:
            state, batch = _lossy_case(rng, 5, k, 700, [3], float_weights,
                                       "cpu")
        else:
            state, batch = _lossy_pattern(
                rng, pattern, 2, k, 3000 if pattern == "phase3" else 1200,
                float_weights, "cpu")
        got, paths = _model_scan(state, batch)
        for g, w in zip(got, _want_scan(state, batch)):
            assert g.tobytes() == w.numpy().tobytes()
        assert paths["phase"] > 0 or pattern is None and k >= 100
        if pattern in _PATTERN_PATH:
            assert paths[_PATTERN_PATH[pattern]] > 0, dict(paths)


def _lossy_requests(rng, ids, extra, n_batches=3, t=300):
    reqs = [
        {"type": "build", "request_id": "b-lc", "synopsis_id": "lc",
         "kind": "lossy_counting", "per_stream_of_source": True,
         "stream_ids": ids[:40]},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-lc",
         "kind": "lossy_counting"},
        {"type": "build", "request_id": "b-narrow", "synopsis_id": "narrow",
         "kind": "lossy_counting", "params": {"eps": 0.05}},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-lc",
         "kind": "lossy_counting", "params": {"eps": 0.05},
         "continuous": True},
        {"type": "build", "request_id": "b-one", "synopsis_id": "one",
         "kind": "lossy_counting", "params": {"eps": 0.05},
         "stream_id": extra},
    ]
    pop = np.asarray(ids, np.int64)
    for b in range(n_batches):
        if b == 1:      # the per-stream stack grows past 64 rows
            reqs.append({"type": "build", "request_id": "b-more",
                         "synopsis_id": "lc2", "kind": "lossy_counting",
                         "per_stream_of_source": True,
                         "stream_ids": ids[40:]})
        sids = pop[(rng.zipf(1.2, t) - 1) % len(pop)].copy()
        sids[::9] = extra
        unrouted = sids[::11]
        sids[::11] = rng.randint(0, 2**62, len(unrouted)) | 1
        sids[::17] = -3                               # negative: masked
        sids[4] = 0                                   # item 0: the cq's
        reqs.append({"type": "ingest", "request_id": f"i{b}",
                     "stream_ids": [int(s) for s in sids],
                     "values": rng.randint(1, 5, t).tolist()})
    return reqs


def test_engine_json_flow_matches_jax_engine():
    """Per-stream (growing past 64 rows), data-source, narrow, continuous
    and single-stream Lossy Counting through ``SDE.handle``: the same
    responses, states, continuous emissions and status; each per-stream
    answer for its own id is its stream's exact total; then stop, rebuild
    (reads 0), and a converted engine that keeps ingesting like the
    reference."""
    rng = np.random.RandomState(31)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=70,
                                                 dtype=np.int64))]
    ids = [0] + ids[:69]
    extra = int(rng.randint(0, 2**62))
    reqs = _lossy_requests(rng, ids, extra)
    n_ingest_reqs = len(reqs)
    reqs += [
        {"type": "adhoc", "request_id": "q-lc", "synopsis_id": f"lc/{ids[2]}",
         "query": {"items": [ids[2], ids[3]]}},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-lc",
         "query": {"items": ids[:20]}},
        {"type": "adhoc", "request_id": "q-def", "synopsis_id": "narrow"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"lc/{i}", "query": {"items": [i]}}
            for i in ids[:40]] + [
            {"synopsis_id": f"lc2/{i}", "query": {"items": [i]}}
            for i in ids[40:]] + [
            {"synopsis_id": "src-lc", "query": {"items": ids}},
            {"synopsis_id": "narrow", "query": {"items": [extra, 5]}},
            {"synopsis_id": "one"},
            {"synopsis_id": "cq-lc", "query": {"items": "bad"}}, 5]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "lc"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "lc",
         "kind": "lossy_counting", "per_stream_of_source": True,
         "stream_ids": ids[:40]},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"lc/{ids[2]}", "query": {"items": [ids[2]]}},
        {"type": "flush", "request_id": "fl"},
    ]
    je, te = JaxSDE(), TorchSDE(device="cpu")
    before = tops.DISPATCH_COUNT["update:LossyCounting"]
    answers = {}
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        assert (ra.request_id, ra.synopsis_id, ra.ok) == \
            (rb.request_id, rb.synopsis_id, rb.ok), (ra, rb)
        assert r["type"] != "build" or rb.ok, rb.error
        if isinstance(ra.value, list):
            for a, b in zip(ra.value, rb.value, strict=True):
                assert (a["request_id"], a["ok"]) == (b["request_id"],
                                                      b["ok"])
                _same(a["value"], b["value"])
            answers = {f"{q['synopsis_id']}": v["value"]
                       for q, v in zip(r["queries"][:-2], rb.value)}
        elif ra.ok:
            _same(ra.value, rb.value)
            if r["type"] != "status":       # the port's status adds device
                assert ra.to_json() == rb.to_json(), r["request_id"]
            else:
                assert ra.value == rb.value
    n_ingest = sum(q["type"] == "ingest" for q in reqs)
    assert tops.DISPATCH_COUNT["update:LossyCounting"] - before == \
        2 * n_ingest                # two kind stacks: eps 0.01 and 0.05
    # each per-stream row only ever saw its own item
    ingests = [q for q in reqs[:n_ingest_reqs] if q["type"] == "ingest"]
    sids = np.concatenate([q["stream_ids"] for q in ingests])
    vals = np.concatenate([q["values"] for q in ingests]).astype(np.float32)
    seen = 0
    for i in ids:
        sid = f"lc/{i}" if i in ids[:40] else f"lc2/{i}"
        got = np.asarray(answers[sid])
        late = sid.startswith("lc2")       # built after the first batch
        sel = sids == i
        if late:
            sel &= np.arange(len(sids)) >= len(ingests[0]["stream_ids"])
        want = np.float32(vals[sel].sum())
        assert got.dtype == np.float32 and got.tolist() == [want], sid
        seen += want > 0
    assert seen > 40
    assert np.asarray(je.stacks[jcore.make_kind("lossy_counting")]
                      .state["keys"]).shape == (128, 100)
    r = te.handle({"type": "adhoc", "request_id": "z",
                   "synopsis_id": f"lc/{ids[2]}",
                   "query": {"items": [ids[2]]}})
    assert r.ok and r.value.tolist() == [0.0]
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        _same_state(te.state_of(sid), je.state_of(sid))
    for sid in ("src-lc", "narrow"):                  # evictions
        assert np.asarray(je.state_of(sid)["error"]).sum() > 0
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    assert len(te.continuous_out) == n_ingest
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same(ra.value, rb.value)
    assert te.memory_bytes() == sum(
        x.nbytes for s in je.stacks.values() for x in s.state.values())

    # carried into a fresh port engine: both keep ingesting alike
    tc = engine_from_contents(jax_contents(je), device="cpu")
    for r in _lossy_requests(rng, ids, extra, n_batches=2)[5:]:
        if r["type"] == "ingest":
            assert je.handle(dict(r)).ok and tc.handle(dict(r)).ok
    for sid in je.entries:
        state = tc.state_of(sid)
        assert state["keys"].dtype == torch.int32
        _same_state(state, je.state_of(sid))
    q = {"type": "query_many", "request_id": "qc", "queries": [
        {"synopsis_id": s, "query": {"items": ids[:8] + [extra]}}
        for s in ("src-lc", "narrow", f"lc/{ids[5]}", "one", "cq-lc")]}
    for a, b in zip(je.handle(dict(q)).value, tc.handle(dict(q)).value,
                    strict=True):
        assert a["ok"] and b["ok"]
        _same(a["value"], b["value"])


def test_init_needs_a_device_and_grow_pads_empty_tables():
    """``init`` and ``stacked_init`` take no default device; ``grow``
    pads new rows with the init prototype (sentinel keys, not zeros: a
    zero key would be item 0); a wrapper given tensors on neither the CPU
    nor a card raises instead of running its plain version."""
    kind = tcore.make_kind("lossy_counting", eps=0.05)
    with pytest.raises(TypeError):
        kind.init()
    with pytest.raises(TypeError):
        tbatched.stacked_init(kind, 4)
    stack = tbatched.stacked_init(kind, 2, "cpu")
    stack["keys"][:] = 0
    grown = tbatched.grow(kind, stack, 8)
    assert grown["keys"].shape == (8, 20)
    assert (grown["keys"][2:] == -1).all() and (grown["keys"][:2] == 0).all()
    _same_state({k: v[2:] for k, v in grown.items()},
                {k: np.asarray(v) for k, v in
                 jbatched.stacked_init(jcore.make_kind(
                     "lossy_counting", eps=0.05), 6).items()})
    meta = {k: v.to("meta") for k, v in grown.items()}
    t = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lossy_scan.lossy_scan_update(meta["keys"], meta["counts"],
                                     meta["error"], t, t,
                                     t.to(torch.float32), t.to(torch.bool))
