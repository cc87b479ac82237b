"""Sticky Sampling (``StickySampling``) in the port against the JAX
package: the kind (``core/sticky.py``) at capacity 8 over 2,000-tuple
batches that cross several epochs, with masks, ids near 2**32 and the
sentinel; its two float functions (``want_epoch`` at every count up to
4,718,590, ``geo`` at every power of two and its float32 neighbours) and
the tables the kernel reads them from; its queries and merge; the stacked
update (``batched.stacked_update``'s scan branch, whose CPU route is the
sticky-scan kernel's plain version) against the reference's vmap, with
the bumps that masked steps take built on purpose; the registry update
(``ops.resolve_update_kernel``, the probe fused or not) against the
reference's probe and vmap; a CPU model of the kernel's order of
operations (``_Model``: a routed run's groups placed at once, a source
walk's stretches spread over a block, adds pending a slot and folded
before each bump) against the plain version, on the card cases and on
the walk's hard cases; and the
engine's JSON flow through ``SDE.handle`` in both packages, fused and
unfused, then carried across by ``convert.engine_from_contents``.

Everything agrees byte for byte: ``keys`` compared as uint32 bits,
``counts`` as float32 bytes, ``n_seen`` and ``epoch`` as int32. The
reference's float functions split from the port's at a few counts and
hashes, all outside what these tests feed it (ROADMAP section 3a); the
float-function tests name each split point."""
import bisect
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.core import sticky as jsticky
from repro.kernels import ops as jops
from repro.service import SDE as JaxSDE
from test_torch_convert import jax_contents
from test_torch_cuda import (STICKY_HARD_PATTERNS, STICKY_PARAMS,
                             _STICKY_CASES, _sticky_case, _sticky_state)
from test_torch_rhp import _same
from test_torch_sampler import _registry_inputs
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.core import hashing
from repro_torch.core import sticky as tsticky
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref, sticky_scan
from repro_torch.service import SDE as TorchSDE

SMALL = STICKY_PARAMS[8]               # capacity 8: t = 128, epochs at 256..
LEAVES = ("counts", "epoch", "keys", "n_seen")


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _same_state(got, want):
    """A port state (dict of tensors, int32 keys) byte-equal to a JAX
    state (uint32 keys)."""
    assert sorted(got) == sorted(want) == list(LEAVES)
    for name in LEAVES:
        w = np.asarray(want[name])
        g = got[name].numpy()
        if name == "keys":
            assert w.dtype == np.uint32 and g.dtype == np.int32
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _jstate(state):
    return {k: jnp.asarray(np.asarray(v).view(np.uint32) if k == "keys"
                           else v) for k, v in state.items()}


def _items(rng, t, pool):
    """Zipf items among ``pool`` ids, the sentinel, ids near 2**32."""
    items = (rng.zipf(1.3, t) % pool).astype(np.int64)
    items[::17] = 0xFFFFFFFF
    items[3::23] = 0xFFFFFFFE
    items[5::29] = rng.randint(2**31, 2**32, items[5::29].size)
    return items.astype(np.uint32)


@pytest.mark.smoke
@pytest.mark.parametrize("n0", [0, 250, 30000, 522000],
                         ids=["n0", "n250", "n30000", "n522000"])
def test_add_batch_matches_jax(n0):
    """The one-row scan (``step_row``, the reference's ``_step`` over every
    tuple, masked ones too) at capacity 8 over two 2,000-tuple batches:
    from a count of 0, just below the first epoch (256), below epoch 8's
    start (32,768) and below epoch 12's (524,288), each run crossing one or
    more epoch starts; a fifth masked, the last tuples masked."""
    jk = jsticky.StickySampling(**SMALL)
    tk = tsticky.StickySampling(**SMALL)
    assert tk.capacity == jk.capacity == 8
    assert tk.memory_bytes() == jk.memory_bytes()
    rng = np.random.RandomState(n0 % 1000 + 1)
    js, ts = jk.init(), tk.init("cpu")
    _same_state(ts, js)
    want = int(tsticky.want_of(torch.tensor([n0]), 128)[0])
    js["n_seen"], js["epoch"] = jnp.int32(n0), jnp.int32(want)
    ts["n_seen"].fill_(n0)
    ts["epoch"].fill_(want)
    for _ in range(2):
        items = _items(rng, 2000, 20)
        mask = rng.rand(2000) > 0.2
        mask[-7:] = False
        js = jk.add_batch(js, jnp.asarray(items), jnp.zeros(2000),
                          jnp.asarray(mask))
        assert tk.add_batch(ts, _t(items), torch.zeros(2000),
                            _t(mask)) is ts
        _same_state(ts, js)
    assert int(ts["epoch"]) > want and (ts["keys"] != tsticky.EMPTY).any()


def _ref_want(n, t):
    """The reference's want_epoch expression (``core/sticky.py:58-61``)."""
    return jnp.maximum(0, jnp.floor(jnp.log2(jnp.maximum(
        n.astype(jnp.float32) / t, 1.0)))).astype(jnp.int32)


def _ref_geo(u):
    """The reference's geo expression (``core/sticky.py:66``)."""
    return jnp.floor(jnp.log(jnp.maximum(u, 1e-9)) / math.log(0.5))


@pytest.mark.parametrize("cap,split", [(288, []), (4096, []),
                                       (8, [1048576, 4194303, 4194304])])
def test_want_epoch_matches_jax_eager_and_jitted(cap, split):
    """``want_epoch`` and its table (``want_of``, the kernel's route)
    against the reference's expression, eager and jitted, at every count
    from 1 to 4,718,590: equal at capacities 288 and 4,096; at capacity 8
    (t = 128) the reference splits from the port at exactly the counts
    ``split`` (its log2 of 8,192.0 is below 13), equal elsewhere. Both
    tie to the reference's own ``_step`` at each epoch start in that range
    and its neighbours, the split counts aside."""
    t = 16 * cap
    n = np.arange(1, 4_718_591, dtype=np.int32)
    port = tsticky.want_epoch(torch.from_numpy(n), t).numpy()
    assert np.array_equal(tsticky.want_of(torch.from_numpy(n), t).numpy(),
                          port)
    eager = np.asarray(_ref_want(jnp.asarray(n), t))
    jitted = np.asarray(jax.jit(_ref_want, static_argnums=1)(
        jnp.asarray(n), t))
    for got in (eager, jitted):
        assert (np.nonzero(got != port)[0] + 1).tolist() == split
    jk = jsticky.StickySampling(**STICKY_PARAMS[cap])
    step = jax.vmap(lambda c: jk._step(
        dict(jk.init(), n_seen=c - 1), jnp.uint32(5), False)["epoch"])
    at = np.asarray([s + d for s in tsticky.epoch_starts(t)
                     for d in (-2, -1, 0, 1)
                     if s + d < 4_718_591 and s + d not in split], np.int32)
    assert np.array_equal(np.asarray(step(jnp.asarray(at))),
                          tsticky.want_epoch(torch.from_numpy(at), t).numpy())


def test_geo_matches_jax_and_its_table():
    """``geo`` against the reference's expression at every power of two
    from 2**0 to 2**-32, at their float32 neighbours and on 200,000
    random draws: equal to the eager reference everywhere, and to the
    jitted one but at u = 2**-27 and its two float32 neighbours (26 there,
    27 here; of the three only 2**-27 is a draw: hash 32). Its table
    (``geo_of``) equals ``geo_of_hash`` at every threshold and its
    neighbours, at every power of two and its neighbours and on random
    hashes; and the reference's own bump decrements each slot by the
    table's geo of its hash."""
    p = np.float32(2.0) ** -np.arange(0, 33, dtype=np.float32)
    u = np.concatenate([p, np.nextafter(p, np.float32(0)),
                        np.nextafter(p, np.float32(2))]).astype(np.float32)
    u = np.concatenate([u, np.random.RandomState(0).rand(200_000).astype(
        np.float32)])
    port = tsticky.geo(torch.from_numpy(u)).numpy()
    eager = np.asarray(_ref_geo(jnp.asarray(u)))
    jitted = np.asarray(jax.jit(_ref_geo)(jnp.asarray(u)))
    assert eager.tobytes() == port.tobytes()
    off = np.nonzero(jitted != port)[0]
    near = np.float32(2.0 ** -27)
    assert sorted(u[off].tolist()) == [
        float(np.nextafter(near, np.float32(0))), float(near),
        float(np.nextafter(near, np.float32(1)))]
    assert set(jitted[off].tolist()) == {26.0}
    at, vals = tsticky.geo_steps()
    assert len(at) + 1 == len(vals) and list(at) == sorted(at)
    hs = {0, 2**32 - 1}
    for x in list(at) + [2**e for e in range(33)]:
        hs.update(h for h in range(x - 2, x + 3) if 0 <= h < 2**32)
    h = torch.tensor(sorted(hs) + np.random.RandomState(1).randint(
        0, 2**32, 100_000, dtype=np.int64).tolist())
    assert tsticky.geo_of(h).numpy().tobytes() == \
        tsticky.geo_of_hash(h).numpy().tobytes()
    jk = jsticky.StickySampling()
    state = dict(jk.init(), counts=jnp.full((jk.capacity,), 40.0),
                 keys=jnp.arange(jk.capacity, dtype=jnp.uint32),
                 n_seen=jnp.int32(9215))
    out = jk._step(state, jnp.uint32(7), False)
    j = torch.arange(jk.capacity, dtype=torch.int64)
    g = tsticky.geo_of(hashing.hash_u32(j ^ 9216, jk.seed)).numpy()
    assert int(out["epoch"]) == 1
    assert np.asarray(out["counts"]).tobytes() == np.maximum(
        np.float32(40.0) - g, 0).astype(np.float32).tobytes()


def test_tables_and_rates_match_the_literal_functions():
    """The kernel's packed tables (``sticky_scan.table_words``) hold each
    capacity's epoch starts, the geo steps and 1 / exp2(e) for e = 0..128
    (0 from 128 on, as the reference's float32 exp2 overflows); each epoch
    start is the first count of its epoch."""
    for cap in (8, 288, 4096):
        t = 16 * cap
        words = sticky_scan.table_words(cap)
        starts = tsticky.epoch_starts(t)
        assert words[0] == len(starts) and words[1] == len(
            tsticky.geo_steps()[0])
        assert words[2:2 + len(starts)].tolist() == list(starts)
        s = torch.tensor(starts, dtype=torch.int64)
        assert np.array_equal(tsticky.want_epoch(s, t).numpy(),
                              np.arange(1, len(starts) + 1))
        assert np.array_equal(tsticky.want_epoch(s - 1, t).numpy(),
                              np.arange(0, len(starts)))
        rates = words[-129:].view(np.float32)
        with np.errstate(over="ignore"):           # exp2(128.0) is inf
            limits = np.float32(1.0) / np.exp2(np.arange(129,
                                                         dtype=np.float32))
        assert rates.tobytes() == limits.astype(np.float32).tobytes()
        assert rates[-1] == 0.0 and rates[-2] > 0.0


def _grown_states(jk, rng):
    """Reference states: empty, part filled, full, past several epochs,
    one with the sentinel's count in an empty slot."""
    states = []
    for n0, t, pool in ((0, 0, 5), (0, 6, 5), (0, 300, 40), (5000, 700, 30),
                        (60, 400, 3)):
        s = jk.init()
        s["n_seen"] = jnp.int32(n0)
        items = _items(rng, t, pool)
        s = jk.add_batch(s, jnp.asarray(items), jnp.zeros(t),
                         jnp.ones(t, bool))
        states.append({k: np.asarray(v) for k, v in s.items()})
    return states


@pytest.mark.parametrize("cap", [8, 288])
def test_queries_and_merge_match_jax(cap):
    """``estimate``, the stacked estimate of a row batch, ``frequent_items``
    and ``merge`` on the reference's own states (empty, part filled,
    full, past several epochs, the sentinel's count in an empty slot),
    items including the sentinel and ids past 2**31."""
    jk = jsticky.StickySampling(**STICKY_PARAMS[cap])
    tk = tsticky.StickySampling(**STICKY_PARAMS[cap])
    states = _grown_states(jk, np.random.RandomState(cap))
    t_states = [{k: _t(v) for k, v in st.items()} for st in states]
    q = np.concatenate([np.arange(0, 40), [0xFFFFFFFF, 0xFFFFFFFE,
                                           2**31 + 5]]).astype(np.uint32)
    for js, ts in zip(states, t_states):
        want = np.asarray(jk.estimate(_jstate(js), jnp.asarray(q)))
        got = tk.estimate(ts, _t(q)).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for g, w in zip(tk.frequent_items(ts), jk.frequent_items(_jstate(js))):
            w = np.asarray(w)
            g = g.numpy().view(np.uint32) if w.dtype == np.uint32 \
                else g.numpy()
            assert g.tobytes() == w.tobytes()
    stack = {k: np.stack([st[k] for st in states]) for k in states[0]}
    rows = np.asarray([2, 0, 4, 2, 1, 3], np.int32)
    qs = np.stack([np.roll(q, i) for i in range(len(rows))])
    want = np.asarray(jk.stacked_estimate(_jstate(stack), jnp.asarray(rows),
                                          jnp.asarray(qs)))
    got = tk.stacked_estimate({k: _t(v) for k, v in stack.items()}, _t(rows),
                              _t(qs)).numpy()
    assert got.tobytes() == want.tobytes() and (want > 0).any()
    for a, b in ((0, 1), (1, 2), (3, 2), (4, 3), (2, 2)):
        _same_state(tk.merge(t_states[a], t_states[b]),
                    jk.merge(_jstate(states[a]), _jstate(states[b])))


def _j_of(state):
    keys, counts, n_seen, epoch = (x.numpy() for x in state)
    return dict(keys=jnp.asarray(keys.view(np.uint32)),
                counts=jnp.asarray(counts), n_seen=jnp.asarray(n_seen),
                epoch=jnp.asarray(epoch))


def _d_of(state):
    return dict(zip(("keys", "counts", "n_seen", "epoch"), state))


@pytest.mark.parametrize("n,cap,t,sources,pattern", [
    c for c in _STICKY_CASES
    if c[1] < 4096 and c[0] < 100 and c[4] not in STICKY_HARD_PATTERNS] + [
    (64, 288, 8192, [0], "streams")] + [
    (4, 288, 4096, [1, 2] if p == "ends" else [1], p)
    for p in STICKY_HARD_PATTERNS if p != "streams"])
def test_stacked_update_matches_jax_vmap(n, cap, t, sources, pattern):
    """``batched.stacked_update``'s scan branch (the kernel wrapper's plain
    version on the CPU) against the reference's vmap of ``add_batch``
    over two batches, on the card tests' cases: empty, part-filled and
    full tables, counts just below epoch starts, epochs behind and ahead
    of their counts, a hot row, rows -1 and n, source rows (one also
    routed to, one listed twice), T = 1; and ``edges``: the bumps masked
    steps take, (a) after a row's last tuple before position T-1, (b) on
    the next batch's first step after a row's last tuple at T-1, with no
    tuple of the row in that batch, and (c) after a row's last tuple
    followed by masked tuples only; and at capacity 288 every hard case
    (``STICKY_HARD_PATTERNS``, T = 4,096, the per-stream rows at 64 x
    8,192) the kernel's order is held to in
    ``test_kernel_order_holds_on_hard_cases``."""
    params = STICKY_PARAMS[cap]
    jk = jcore.make_kind("sticky_sampling", **params)
    tk = tcore.make_kind("sticky_sampling", **params)
    assert tk.update_kernel == "sticky_scan"
    rng = np.random.RandomState(n + cap + t)
    state, batches = _sticky_case(rng, n, cap, t, sources, pattern, "cpu")
    jstate, tstate = _j_of(state), _d_of([x.clone() for x in state])
    before = sticky_scan.sticky_scan_update.launches
    epochs = []
    for rows, items, mask, src in batches:
        jstate = jbatched.stacked_update(
            jk, jstate, jnp.asarray(rows.numpy()),
            jnp.asarray(items.numpy().view(np.uint32)), jnp.zeros(t),
            jnp.asarray(mask.numpy()),
            None if src is None else jnp.asarray(src.numpy()))
        assert tbatched.stacked_update(tk, tstate, rows, items,
                                       torch.zeros(t), mask, src) is tstate
        _same_state(tstate, jstate)
        epochs.append(tstate["epoch"][:3].tolist())
    assert sticky_scan.sticky_scan_update.launches == before
    if pattern == "edges":
        # (a) row 0 bumps in batch 1; (b) row 1 only at batch 2's start;
        # (c) row 2 after its masked tail in batch 2
        assert epochs == [[1, 0, 0], [1, 1, 1]]
        assert int(tstate["n_seen"][1]) == int(state[2][1]) + 3


def test_stacked_update_on_a_grown_stack_matches_jax_vmap():
    """A stack grown from 4 to 12 rows (new rows at init: empty keys) over
    three batches, a source row among the new ones; then the reference's
    and the port's ``grow`` give the same rows."""
    jk = jcore.make_kind("sticky_sampling", **SMALL)
    tk = tcore.make_kind("sticky_sampling", **SMALL)
    rng = np.random.RandomState(11)
    keys, counts, n_seen, epoch = _sticky_state(rng, 4, 8, "epochs")
    state = dict(keys=keys.astype(np.uint32), counts=counts,
                 n_seen=n_seen.astype(np.int32), epoch=epoch.astype(np.int32))
    jstate = _jstate(state)
    tstate = {k: _t(v) for k, v in state.items()}
    jstate = jbatched.grow(jk, jstate, 12)
    tstate = tbatched.grow(tk, tstate, 12)
    _same_state(tstate, jstate)
    src = np.asarray([9], np.int32)
    for _ in range(3):
        rows = rng.randint(-1, 13, 1500).astype(np.int32)
        items = _items(rng, 1500, 20)
        mask = rng.rand(1500) > 0.1
        jstate = jbatched.stacked_update(jk, jstate, jnp.asarray(rows),
                                         jnp.asarray(items),
                                         jnp.zeros(1500), jnp.asarray(mask),
                                         jnp.asarray(src))
        tbatched.stacked_update(tk, tstate, _t(rows), _t(items),
                                torch.zeros(1500), _t(mask), _t(src).long())
        _same_state(tstate, jstate)
    assert int(tstate["epoch"][9]) >= 3


@pytest.mark.parametrize("sources", [None, [3, 31, 3]],
                         ids=["no_source", "sources"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_registry_update_matches_jax_probe_and_vmap(fuse, sources):
    """The registry's Sticky update (``resolve_update_kernel``: the fused
    entry, or the plain probe ahead of the rows-given one) over two
    batches, byte for byte against the JAX package's probe plus its vmapped
    ``stacked_update`` and against the port's ``route_probe`` plus
    ``batched.stacked_update``: ids displaced beyond ``n_probe``, ids not
    in the table and negative ids take no row, hot rows many tuples,
    data-source rows every masked tuple, counts near epoch starts."""
    jk = jcore.make_kind("sticky_sampling", **SMALL)
    tk = tcore.make_kind("sticky_sampling", **SMALL)
    x = _registry_inputs(5 + (sources is None), 16, sources)
    n = len(x["pop"]) + 2
    keys, counts, n_seen, epoch = _sticky_state(np.random.RandomState(2), n,
                                                8, "epochs")
    state = dict(keys=keys.astype(np.uint32), counts=counts,
                 n_seen=n_seen.astype(np.int32), epoch=epoch.astype(np.int32))
    items = (x["items"] % np.uint32(24)).astype(np.uint32)
    items[::13] = 0xFFFFFFFF
    jstate = _jstate(state)
    tstate = {k: _t(v) for k, v in state.items()}
    plain = {k: v.clone() for k, v in tstate.items()}
    fn = tops.resolve_update_kernel(tk, fuse)
    before = (sticky_scan.sticky_scan_update.launches,
              sticky_scan.sticky_probe_scan_update.launches)
    for _ in range(2):
        jargs = [jnp.asarray(a) for a in (*x["table"], *x["sids"])]
        rows = jops.route_probe(*jargs, n_probe=x["n_probe"])
        jstate = jbatched.stacked_update(
            jk, jstate, rows, jnp.asarray(items), jnp.asarray(x["vals"]),
            jnp.asarray(x["mask"]),
            None if x["src"] is None else jnp.asarray(x["src"]))
        targs = [_t(a) for a in (*x["table"], *x["sids"], items, x["vals"],
                                 x["mask"])]
        src = None if x["src"] is None else _t(x["src"]).long()
        assert fn(tstate, *targs, src, n_probe=x["n_probe"]) is tstate
        trows = tops.route_probe(*targs[:5], n_probe=x["n_probe"])
        assert np.array_equal(trows.numpy(), np.asarray(rows))
        tbatched.stacked_update(tk, plain, trows, *targs[5:], src)
        _same_state(tstate, jstate)
        _same_state(plain, jstate)
    assert (sticky_scan.sticky_scan_update.launches,
            sticky_scan.sticky_probe_scan_update.launches) == before
    if sources is not None:                    # every masked tuple, twice
        assert int(tstate["n_seen"][31]) == int(n_seen[31]) + 2 * int(
            x["mask"].sum())


def _mix32(h):
    for shift, mult in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, 1)):
        h = ((h ^ (h >> shift)) * mult) & 0xFFFFFFFF
    return h


def _quiet(c):
    """A NaN as the host's float arithmetic returns it: payload, quieted."""
    return np.asarray(c, np.float32).reshape(1).view(np.int32).__or__(
        0x00400000).view(np.float32)[0]


def _add_ones(c, m, paths):
    """The kernel's fold of m adds of 1.0f into count c (``add_ones``):
    min(c + m, 2**24) for an integer c in [-2**24, 2**24], else one add at
    a time until it holds or the count stops moving; a NaN quieted."""
    c = np.float32(c)
    while m > 0:
        if np.isnan(c):
            paths["folds of a NaN"] += 1
            return _quiet(c)
        if abs(c) <= 2**24 and c == np.trunc(c):
            paths["folds in closed form"] += 1
            s = int(c) + m
            return np.float32(2**24 if s >= 2**24 else s)
        paths["fold steps one add at a time"] += 1
        d = np.float32(c + np.float32(1.0))
        if d == c:
            return c
        c, m = d, m - 1
    return c


class _ModelTable:
    """One walk's table as ``csrc/sticky_scan.cu`` keeps it in shared
    memory: the keys, each slot's pending adds, the item -> first slot
    hash index (16-bit entries, linear probing, ``spread`` cap entries or
    more: 2 for a routed walk, 8 for a source walk) and the empty slots in
    slot order (``elist``, taken from the front)."""

    def __init__(self, model, r, spread):
        self.m, self.r = model, r
        self.key = model.keys[r].copy()
        self.pend = np.zeros(model.cap, np.int64)
        bits = 5
        while (1 << bits) < spread * model.cap:
            bits += 1
        self.size, self.shift = 1 << bits, 32 - bits
        self.bumped = False
        self.reindex()

    def hslot(self, x):
        return (((x & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF) >> self.shift

    def reindex(self):
        self.idx = [None] * self.size
        for j in range(self.m.cap):
            if self.key[j] != -1:
                self.insert(int(self.key[j]), j)
        self.elist = np.flatnonzero(self.key == -1).tolist()
        self.eo = 0

    def insert(self, x, j):
        h = self.hslot(x)
        while self.idx[h] is not None:
            if self.key[self.idx[h]] == x:
                self.idx[h] = min(self.idx[h], j)
                return
            h = (h + 1) % self.size
        self.idx[h] = j

    def lookup(self, x):
        h = self.hslot(x)
        probes = 0
        while self.idx[h] is not None:
            if self.key[self.idx[h]] == x:
                self.m.paths["lookups past their first entry"] += probes > 0
                return self.idx[h]
            h, probes = (h + 1) % self.size, probes + 1
        return None

    def room(self):
        return len(self.elist) - self.eo

    def fold(self):
        counts = self.m.counts[self.r]
        for j in np.flatnonzero(self.pend):
            counts[j] = _add_ones(counts[j], int(self.pend[j]), self.m.paths)
        self.pend[:] = 0

    def bump(self, nu):
        """A bump inside the walk: a NaN keeps its payload, quieted."""
        counts = self.m.counts[self.r]
        for j in range(self.m.cap):
            c0 = counts[j]
            d = (_quiet(c0) if np.isnan(c0)
                 else np.float32(c0 - self.m.geo(j, nu)))
            c = np.float32(0.0) if d < 0 else d
            counts[j] = c
            if c <= 0:
                self.key[j] = -1
        self.bumped = True


class _Model:
    """A test-only model of the sticky-scan kernel's order of operations
    (``csrc/sticky_scan.cu``); integer tables and numpy float32 only.

    Every row's check at the batch's first step (``bump_kernel``); the key
    pass (routed tuples of source rows dropped) and the stable sort; then
    the walks. A routed run is walked 32 sorted positions a group: each
    lane's count and check first; the lanes before the first due check
    placed at once (``place``), then fold, bump, index anew, and on from
    that lane. A source row is walked 1,024 batch positions a chunk, its
    masked tuples by rank, a stretch (``stretch``) up to each due check,
    and the bump there taken on the spot. Adds go to ``pend`` and reach the
    counts at a fold (before a bump, at the walk's end), in closed form
    where exact. The check after the walk where its last tuple is not the
    batch's last; then the keys back: every slot after a bump, else only
    the slots the admissions took."""

    def __init__(self, state, params):
        self.keys, self.counts, self.n_seen, self.epoch = (
            x.numpy().copy() for x in state)
        kind = tsticky.StickySampling(**params)
        self.cap = kind.capacity
        self.starts = tsticky.epoch_starts(16 * self.cap)
        self.at, self.vals = tsticky.geo_steps()
        self.rates = np.asarray(tsticky.inv_rates(), np.float32)
        self.mixes = [((s & 0xFFFFFFFF) * 0x9E3779B9 + 1) & 0xFFFFFFFF
                      for s in (kind.seed, kind.seed + 1)]
        self.paths = collections.Counter()

    @staticmethod
    def i32(u):
        return u - 2**32 if u >= 2**31 else u

    def want(self, nu):
        return bisect.bisect_right(self.starts, self.i32(nu))

    def due(self, nu, e):
        return e < 0 or (e < len(self.starts)
                         and self.i32(nu) >= self.starts[e])

    def geo(self, j, nu):
        return np.float32(self.vals[bisect.bisect_right(
            self.at, _mix32((j ^ nu) ^ self.mixes[0]))])

    def admits(self, x, nu, e):
        h = _mix32(((x & 0xFFFFFFFF) ^ nu) ^ self.mixes[1])
        u = np.float32(np.float32(h) * np.float32(2.0 ** -32))
        return bool(u < self.rates[min(e, 128)])

    def first_bump(self, r, nu):
        """bump_kernel's decrement (numpy on the host here; on the card
        the card's subtract, as torch's there)."""
        for j in range(self.cap):
            d = np.float32(self.counts[r, j] - self.geo(j, nu))
            c = np.float32(0.0) if d < 0 else d
            self.counts[r, j] = c
            if c <= 0:
                self.keys[r, j] = -1

    def place(self, tab, w, xs, ns, ranks=None, arank=None):
        """Lanes xs (counts ns) on the table as it stands; with ``arank``
        each admission's rank (``ranks``) is appended to it."""
        slot = [None] * len(xs)
        miss = [False] * len(xs)
        for i, x in enumerate(xs):
            if x != -1:
                slot[i] = tab.lookup(x)
                miss[i] = slot[i] is None
        room = tab.room()
        sent = [i for i, x in enumerate(xs) if x == -1]
        if room > 0 and (any(miss) or sent):
            lead = {}                       # item -> its first admitted lane
            for i, x in enumerate(xs):
                if miss[i] and x not in lead and self.admits(
                        x, ns[i] & 0xFFFFFFFF, w["epoch"]):
                    lead[x] = i
            order = sorted(lead.values())
            self.paths["admitters past the last empty slot"] += \
                len(order) > room
            for rank, i in enumerate(order):
                if rank < room:
                    j = tab.elist[tab.eo + rank]
                    tab.key[j] = xs[i]
                    tab.insert(xs[i], j)
                    slot[i] = j
                    self.paths["admissions within a group"] += 1
                    if arank is not None:
                        arank.append(ranks[i])
            for i, x in enumerate(xs):
                if miss[i] and x in lead and i > lead[x]:
                    slot[i] = slot[lead[x]]
                    self.paths["items admitted twice in a group"] += \
                        slot[i] is not None
            for i in sent:
                rank = sum(k < i for k in order)
                if rank < room:
                    slot[i] = tab.elist[tab.eo + rank]
                    self.paths["sentinels into an empty slot"] += 1
            tab.eo += min(len(order), room)
        for s in slot:
            if s is not None:
                tab.pend[s] += 1

    def group(self, tab, w, xs, n_first):
        lo = 0
        while True:
            due = [i for i in range(lo, len(xs))
                   if self.due((n_first + i) & 0xFFFFFFFF, w["epoch"])]
            b = due[0] if due else len(xs)
            if b > lo:
                self.place(tab, w, xs[lo:b],
                           [n_first + i for i in range(lo, b)])
            if not due:
                return
            nb = (n_first + b) & 0xFFFFFFFF
            tab.fold()
            tab.bump(nb)
            w["epoch"] = self.want(nb)
            tab.reindex()
            self.paths["bumps within a group"] += 1
            lo = b

    def stretch(self, tab, w, sx, r0, r1, n0):
        """The ranks [r0, r1) of a source chunk, no check due among them:
        on a full table a lookup and an add each; else every rank looks
        its item up at once (a hit adds), the misses whose coin admits
        them (candidates) are placed 32 at a time in rank order, then
        every other miss hits the slot its item took at an earlier rank
        and a sentinel adds to the empty slot the admissions before it
        left first."""
        if tab.room() == 0:
            assert not (tab.key == -1).any()
            for x in sx[r0:r1]:
                s = tab.lookup(x) if x != -1 else None
                if s is not None:
                    tab.pend[s] += 1
            self.paths["full-table stretches"] += r1 > r0
            self.paths["full-table steps"] += r1 - r0
            return
        self.paths["stretches with an empty slot"] += 1
        cls, cands = {}, []
        for r in range(r0, r1):
            x = sx[r]
            if x == -1:
                cls[r] = "sentinel"
                continue
            s = tab.lookup(x)
            if s is not None:
                tab.pend[s] += 1
                cls[r] = "hit"
            elif self.admits(x, (n0 + 1 + r) & 0xFFFFFFFF, w["epoch"]):
                cls[r] = "candidate"
                cands.append(r)
            else:
                cls[r] = "miss"
        eo0, arank = tab.eo, []
        for i in range(0, len(cands), 32):
            grp = cands[i:i + 32]
            self.place(tab, w, [sx[r] for r in grp],
                       [n0 + 1 + r for r in grp], grp, arank)
            self.paths["candidate groups"] += 1
        assert arank == sorted(arank) and len(arank) == tab.eo - eo0
        for r in range(r0, r1):
            s = None
            if cls[r] == "miss" and arank:
                s = tab.lookup(sx[r])
                if s is not None:
                    k = tab.elist.index(s, eo0, tab.eo) - eo0
                    if arank[k] > r:
                        s = None
                    else:
                        self.paths["misses that hit a slot taken earlier "
                                   "in their stretch"] += 1
            elif cls[r] == "sentinel":
                a = eo0 + bisect.bisect_left(arank, r)
                if a < len(tab.elist):
                    s = tab.elist[a]
                    self.paths["sentinels into an empty slot"] += 1
            if s is not None:
                tab.pend[s] += 1

    def source(self, tab, w, items, mask):
        t = len(mask)
        n0, last = w["n_seen"], -1
        for c0 in range(0, t, 1024):
            pos = [p for p in range(c0, min(c0 + 1024, t)) if mask[p]]
            if not pos:
                continue
            last, total = pos[-1], len(pos)
            sx = [int(items[p]) for p in pos]

            def due_from(r0):
                return next((r for r in range(r0, total) if self.due(
                    (n0 + 1 + r) & 0xFFFFFFFF, w["epoch"])), total)

            rstart, b = 0, due_from(0)
            while True:
                self.stretch(tab, w, sx, rstart, b, n0)
                if b >= total:
                    break
                nb = (n0 + 1 + b) & 0xFFFFFFFF
                tab.fold()
                tab.bump(nb)
                w["epoch"] = self.want(nb)
                tab.reindex()
                self.paths["bumps in a source walk"] += 1
                rstart = b
                b = due_from(rstart)
            n0 = (n0 + total) & 0xFFFFFFFF
        w["n_seen"] = n0
        return last

    def run(self, tab, w, items, tix):
        for g in range(0, len(tix), 32):
            xs = [int(items[p]) for p in tix[g:g + 32]]
            self.group(tab, w, xs, (w["n_seen"] + 1) & 0xFFFFFFFF)
            self.paths["groups of a routed run"] += 1
            w["n_seen"] = (w["n_seen"] + len(xs)) & 0xFFFFFFFF
        return int(tix[-1])

    def scan(self, batch):
        rows, items, mask, src = (None if x is None else x.numpy()
                                  for x in batch)
        n, t = len(self.n_seen), len(rows)
        if t == 0:
            return
        for r in range(n):
            nu = (int(self.n_seen[r]) + 1) & 0xFFFFFFFF
            if self.due(nu, int(self.epoch[r])):
                self.first_bump(r, nu)
                self.epoch[r] = self.want(nu)
                self.paths["first-step bumps"] += 1
        srcs = []
        for r in [] if src is None else src.tolist():
            if 0 <= r < n and r not in srcs:
                srcs.append(r)
        flag = np.zeros(n, bool)
        flag[srcs] = True
        keep = mask & (rows >= 0) & (rows < n)
        keep[keep] &= ~flag[rows[keep]]
        kept = np.nonzero(keep)[0]
        perm = kept[np.argsort(rows[kept], kind="stable")]
        walks = [(r, None) for r in srcs]
        walks += [(r, perm[rows[perm] == r])
                  for r in np.unique(rows[perm]).tolist()]
        for r, tix in walks:
            tab = _ModelTable(self, r, 2 if tix is not None else 8)
            w = dict(n_seen=int(self.n_seen[r]) & 0xFFFFFFFF,
                     epoch=int(self.epoch[r]))
            last = (self.source(tab, w, items, mask) if tix is None
                    else self.run(tab, w, items, tix))
            tab.fold()
            if 0 <= last < t - 1:
                c = (w["n_seen"] + 1) & 0xFFFFFFFF
                if self.due(c, w["epoch"]):
                    tab.bump(c)
                    w["epoch"] = self.want(c)
                    self.paths["end-of-walk bumps"] += 1
            taken = (range(self.cap) if tab.bumped
                     else tab.elist[:tab.eo])
            for j in taken:
                self.keys[r, j] = tab.key[j]
            self.n_seen[r], self.epoch[r] = self.i32(w["n_seen"]), w["epoch"]


def _model_scan(state, batch, params):
    """The kernel's order (``_Model``) over one batch: returns the stack
    (numpy) and the paths taken."""
    model = _Model(state, params)
    model.scan(batch)
    return (model.keys, model.counts, model.n_seen, model.epoch), model.paths


def _hold_model(cases, paths):
    """Each case's batches through the model and the plain version, the
    four leaves byte for byte after each; the model's paths added up."""
    for n, cap, t, sources, pattern in cases:
        params = STICKY_PARAMS[cap]
        rng = np.random.RandomState(n + cap + t)
        state, batches = _sticky_case(rng, n, cap, t, sources, pattern,
                                      "cpu")
        want = [x.clone() for x in state]
        for batch in batches:
            got, p = _model_scan(state, batch, params)
            paths.update(p)
            ref.sticky_scan_update(*want, *batch, **params)
            for g, w in zip(got, want):
                assert g.tobytes() == w.numpy().tobytes(), pattern
            state = [torch.from_numpy(g) for g in got]


def test_kernel_order_matches_the_plain_version():
    """The sticky-scan kernel's order of operations (``_model_scan``)
    byte for byte against the plain version (``ref.sticky_scan_update``,
    held to the reference's vmap above) over two batches on the card
    cases of capacity 8 and 288 of the patterns before the hard ones; the
    first-step, in-walk (in a routed run's group and in a source walk)
    and end-of-walk bumps, admissions within a group, full-table
    stretches and stretches with an empty slot (candidates placed in
    groups, misses that hit a slot taken earlier in their stretch,
    sentinels into empty slots) and lookups past their first index entry
    each happen."""
    paths = collections.Counter()
    _hold_model([c for c in _STICKY_CASES if c[1] < 4096 and c[0] <= 100
                 and c[4] not in STICKY_HARD_PATTERNS], paths)
    for k in ("first-step bumps", "bumps within a group",
              "bumps in a source walk", "end-of-walk bumps",
              "admissions within a group", "full-table stretches",
              "stretches with an empty slot", "candidate groups",
              "misses that hit a slot taken earlier in their stretch",
              "sentinels into an empty slot",
              "lookups past their first entry"):
        assert paths[k] > 0, dict(paths)


# each hard case, at capacity 288, and the paths it must take
_HARD_PATHS = {
    "phase3": ("admissions within a group", "full-table stretches",
               "items admitted twice in a group",
               "stretches with an empty slot"),
    "refill": ("bumps within a group", "bumps in a source walk",
               "admissions within a group", "full-table stretches",
               "misses that hit a slot taken earlier in their stretch"),
    "ends": ("bumps in a source walk", "full-table stretches"),
    "twice": ("items admitted twice in a group",
              "admitters past the last empty slot"),
    "sentinels": ("sentinels into an empty slot",
                  "admissions within a group"),
    "repeats": ("bumps in a source walk", "admissions within a group"),
    "odd": ("fold steps one add at a time", "folds of a NaN",
            "folds in closed form", "bumps in a source walk"),
    "streams": ("bumps within a group", "bumps in a source walk",
                "items admitted twice in a group"),
}


@pytest.mark.parametrize("pattern", sorted(_HARD_PATHS))
def test_kernel_order_holds_on_hard_cases(pattern):
    """The kernel's order (``_model_scan``) byte for byte against the
    plain version on the hard cases at capacity 288 (4 rows, a source row,
    two batches of 4,096 tuples; ``STICKY_HARD_PATTERNS``): phase 3's
    traffic (Zipf(1.1) ids folded by ``fold64``, 10% unique); a table a
    bump empties and the walk fills again; a full-table stretch that ends
    at an epoch start and one across the int32 wrap; an item admitted
    twice in a group beside more admitters than empty slots; sentinel
    bursts; keys repeated in a row; hit slots at 2**24 - 3 .. 2**24 + 2,
    0.5, 1e30, NaN, +-inf, -0.0 and -3; per-stream rows (64 rows, one item
    each, 8,192 tuples) whose long runs cross an epoch start. Each takes
    its paths."""
    paths = collections.Counter()
    _hold_model([(64, 288, 8192, [0], pattern) if pattern == "streams" else
                 (4, 288, 4096, [1, 2] if pattern == "ends" else [1],
                  pattern)], paths)
    for k in _HARD_PATHS[pattern]:
        assert paths[k] > 0, (pattern, dict(paths))
    if pattern == "ends":                       # the wrap row's counts wrap
        assert paths["full-table steps"] > 3000


def _requests(rng, ids, extra, n_batches=3, t=300):
    small = {k: SMALL[k] for k in ("support", "eps", "delta")}
    reqs = [
        {"type": "build", "request_id": "b-ss", "synopsis_id": "ss",
         "kind": "sticky_sampling", "params": small,
         "per_stream_of_source": True, "stream_ids": ids[:40]},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-ss",
         "kind": "sticky_sampling", "params": small},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-ss",
         "kind": "sticky_sampling", "params": small, "continuous": True},
        {"type": "build", "request_id": "b-one", "synopsis_id": "one",
         "kind": "sticky_sampling", "stream_id": extra},
    ]
    pop = np.asarray(ids, np.int64)
    for b in range(n_batches):
        if b == 1:      # the per-stream stack grows past 64 rows
            reqs.append({"type": "build", "request_id": "b-more",
                         "synopsis_id": "ss2", "kind": "sticky_sampling",
                         "params": small, "per_stream_of_source": True,
                         "stream_ids": ids[40:]})
        sids = pop[(rng.zipf(1.2, t) - 1) % len(pop)].copy()
        sids[::9] = extra
        unrouted = sids[::11]
        sids[::11] = rng.randint(0, 2**62, len(unrouted)) | 1
        sids[::17] = -3                               # negative: masked
        reqs.append({"type": "ingest", "request_id": f"i{b}",
                     "stream_ids": [int(x) for x in sids],
                     "values": (rng.randn(t) * 2).round(3).tolist()})
    return reqs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_engine_json_flow_matches_jax_engine(monkeypatch, fused):
    """Per-stream (capacity 8, growing past 64 rows), data-source and
    continuous Sticky Sampling and a single-stream one at the defaults
    (capacity 288) through ``SDE.handle``: the same JSON responses (adhoc
    and query_many with ``items``, the default item ``[0]``, a malformed
    entry failing alone), states, continuous emissions and status; the
    data-source rows cross epochs; then stop, rebuild (reads 0) and a
    converted engine that keeps ingesting like the reference. Each ingest
    takes the registry route: the fused entry, or the plain probe and the
    rows-given one."""
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    calls = collections.Counter()
    for name in ("sticky_probe_scan_update", "sticky_scan_update"):
        real = getattr(sticky_scan, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(sticky_scan, name, spy)
    rng = np.random.RandomState(43)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=70,
                                                 dtype=np.int64))]
    ids = [0] + ids[:69]
    extra = int(rng.randint(0, 2**62))
    reqs = _requests(rng, ids, extra)
    own = lambda i: [int(i)]
    reqs += [
        {"type": "adhoc", "request_id": "q-ss", "synopsis_id": f"ss/{ids[2]}",
         "query": {"items": own(ids[2])}},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-ss",
         "query": {"items": ids[:10] + [2**63 - 1]}},
        {"type": "adhoc", "request_id": "q-one", "synopsis_id": "one",
         "query": {"items": [extra]}},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"ss/{i}", "query": {"items": own(i)}}
            for i in ids[:40]] + [
            {"synopsis_id": f"ss2/{i}", "query": {"items": own(i)}}
            for i in ids[40:]] + [
            {"synopsis_id": "src-ss", "query": {"items": ids[:30]}},
            {"synopsis_id": "one", "query": {"items": [extra, 5]}},
            {"synopsis_id": "cq-ss"},
            {"synopsis_id": "src-ss", "query": {"items": [-4]}},
            {"synopsis_id": "nope"}, 5]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "ss"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "ss",
         "kind": "sticky_sampling",
         "params": {k: SMALL[k] for k in ("support", "eps", "delta")},
         "per_stream_of_source": True, "stream_ids": ids[:40]},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"ss/{ids[2]}", "query": {"items": own(ids[2])}},
        {"type": "flush", "request_id": "fl"},
    ]
    je, te = JaxSDE(), TorchSDE(device="cpu")
    before = tops.DISPATCH_COUNT["update:StickySampling"]
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
            answers = {q["synopsis_id"]: v["value"]
                       for q, v in zip(r["queries"][:-3], rb.value)}
            assert ra.to_json() == rb.to_json()
        elif ra.ok:
            _same(ra.value, rb.value)
            if r["type"] != "status":       # the port's status adds device
                assert ra.to_json() == rb.to_json(), r["request_id"]
            else:
                assert ra.value == rb.value
    n_ingest = sum(q["type"] == "ingest" for q in reqs)
    assert tops.DISPATCH_COUNT["update:StickySampling"] - before == \
        2 * n_ingest                # two kind stacks: capacity 8 and 288
    route = "sticky_probe_scan_update" if fused else "sticky_scan_update"
    assert calls == {route: 2 * n_ingest}
    r = te.handle({"type": "adhoc", "request_id": "z",
                   "synopsis_id": f"ss/{ids[2]}",
                   "query": {"items": own(ids[2])}})
    assert r.ok and float(r.value[0]) == 0.0
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        _same_state(te.state_of(sid), je.state_of(sid))
    assert int(te.state_of("src-ss")["epoch"]) >= 2
    assert float(answers["src-ss"].max()) > 0
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    assert len(te.continuous_out) == n_ingest
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same(ra.value, rb.value)
        assert ra.to_json() == rb.to_json()
    assert te.memory_bytes() == sum(
        x.nbytes for s in je.stacks.values() for x in s.state.values())

    # carried into a fresh port engine: both keep ingesting alike
    tc = engine_from_contents(jax_contents(je), device="cpu")
    for r in _requests(rng, ids, extra, n_batches=2)[4:]:
        if r["type"] == "ingest":
            assert je.handle(dict(r)).ok and tc.handle(dict(r)).ok
    for sid in je.entries:
        state = tc.state_of(sid)
        assert state["keys"].dtype == torch.int32
        _same_state(state, je.state_of(sid))
    q = {"type": "query_many", "request_id": "qc", "queries": [
        {"synopsis_id": s, "query": {"items": ids[:12]}}
        for s in ("src-ss", "one", f"ss/{ids[5]}", "cq-ss")]}
    ra, rb = je.handle(dict(q)), tc.handle(dict(q))
    assert ra.to_json() == rb.to_json()


def test_reference_stack_carries_across():
    """A reference engine's Sticky stack (uint32 ``keys`` with the
    sentinel, float32 ``counts``, int32 ``n_seen`` and ``epoch`` [n])
    restores into the port through ``engine_from_contents``, keys as their
    int32 bits, and answers as the reference does."""
    rng = np.random.RandomState(7)
    ids = [int(s) for s in rng.randint(0, 2**63 - 1, 12, dtype=np.int64)]
    je = JaxSDE()
    small = {k: SMALL[k] for k in ("support", "eps", "delta")}
    assert je.handle({"type": "build", "request_id": "b", "synopsis_id": "ss",
                      "kind": "sticky_sampling", "params": small,
                      "per_stream_of_source": True, "stream_ids": ids}).ok
    assert je.handle({"type": "build", "request_id": "c",
                      "synopsis_id": "src", "kind": "sticky_sampling",
                      "params": small}).ok
    for _ in range(2):
        sids = np.asarray(ids, np.int64)[rng.randint(0, 12, 200)]
        je.ingest(sids, rng.randn(200).astype(np.float32))
    contents = jax_contents(je)
    (stack,) = contents["stacks"]
    assert stack["state"]["keys"].dtype == np.uint32
    assert int(stack["state"]["keys"].max()) == 0xFFFFFFFF     # empty slots
    assert int(stack["state"]["keys"][stack["state"]["keys"]
                                      != 0xFFFFFFFF].max()) >= 2**31
    tc = engine_from_contents(contents, device="cpu")
    state = tc.stacks[tcore.make_kind("sticky_sampling", **small)].state
    assert state["keys"].dtype == torch.int32
    for name in ("n_seen", "epoch"):
        assert state[name].dtype == torch.int32 and state[name].dim() == 1
    assert int(state["epoch"].max()) >= 1
    for sid in je.entries:
        _same_state(tc.state_of(sid), je.state_of(sid))
    q = {"type": "query_many", "request_id": "q", "queries": [
        {"synopsis_id": "src", "query": {"items": ids}}] + [
        {"synopsis_id": f"ss/{i}", "query": {"items": [i]}} for i in ids]}
    ra, rb = je.handle(dict(q)), tc.handle(dict(q))
    assert ra.to_json() == rb.to_json()


def test_init_needs_a_device_and_the_wrapper_refuses_other_devices():
    """``init`` and ``stacked_init`` take no default device; ``grow``
    pads new rows with empty tables; the kind's status reports its
    parameters and its capacity follows the reference's (8 at least,
    4,096 at most); a wrapper given tensors on neither the CPU nor a card
    raises instead of running its plain version."""
    kind = tcore.make_kind("sticky_sampling")
    assert tcore.kind_params(kind) == {"support": 0.01, "eps": 0.002,
                                       "delta": 0.01, "seed": 37}
    for params in ({}, SMALL, STICKY_PARAMS[4096],
                   {"support": 0.5, "eps": 0.9, "delta": 0.5}):
        assert tcore.make_kind("sticky_sampling", **params).capacity == \
            jcore.make_kind("sticky_sampling", **params).capacity
    assert STICKY_PARAMS[4096] and tcore.make_kind(
        "sticky_sampling", **STICKY_PARAMS[4096]).capacity == 4096
    assert not hasattr(kind, "stacked_add_batch")
    with pytest.raises(TypeError):
        kind.init()
    with pytest.raises(TypeError):
        tbatched.stacked_init(kind, 4)
    stack = tbatched.stacked_init(kind, 2, "cpu")
    stack["n_seen"][:] = 3
    grown = tbatched.grow(kind, stack, 8)
    assert grown["keys"].shape == (8, 288) and grown["epoch"].shape == (8,)
    _same_state({k: v[2:] for k, v in grown.items()},
                {k: np.asarray(v) for k, v in jbatched.stacked_init(
                    jcore.make_kind("sticky_sampling"), 6).items()})
    meta = {k: v.to("meta") for k, v in grown.items()}
    t = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sticky_scan.sticky_scan_update(
            meta["keys"], meta["counts"], meta["n_seen"], meta["epoch"], t, t,
            t.to(torch.bool), **kind.params())
