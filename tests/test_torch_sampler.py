"""The chain sampler (``ReservoirSampler``) in the port against the JAX
package: the kind (``core/sampler.py``) at S = 1, 16 and 64, with counts
from 0 through the fill, near 2**24 (where float32(n + 1) rounds) and up
to 2**31 - 2T; its queries and merge; the stacked update
(``batched.stacked_update``'s scan branch, whose CPU route is the
reservoir kernel's plain version) against the reference's vmap; the
registry update (``ops.resolve_update_kernel``, the probe fused or not)
against the reference's probe and vmap; a CPU model of the kernel's
order (rank, slot, then each slot's last writer) against the per-tuple
loop; and the engine's JSON flow through ``SDE.handle`` in both
packages (the registry route, probe fused), then carried across by
``convert.engine_from_contents``.

Everything agrees byte for byte: ``items`` compared as uint32 bits,
``values`` as float32 bytes, ``n_seen`` as int32. Answers give ``items``
as uint32, so ids of 2**31 and above stay positive in the JSON."""
import collections

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.core import sampler as jsampler
from repro.kernels import ops as jops
from repro.service import SDE as JaxSDE
from test_torch_convert import jax_contents
from test_torch_cuda import (RESERVOIR_SEED, _RESERVOIR_CASES,
                             _reservoir_case, _reservoir_step)
from test_torch_rhp import _same
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.core import sampler as tsampler
from repro_torch.kernels import ref, reservoir_scan
from repro_torch.kernels import ops as tops
from repro_torch.service import SDE as TorchSDE
from repro_torch.service import routing

T = 500
COUNTS = [0, 5, 2**24 - 200, 2**31 - 2 * T]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _same_state(got, want):
    """A port state (dict of tensors, int32 items) byte-equal to a JAX
    state (uint32 items)."""
    assert sorted(got) == sorted(want) == ["items", "n_seen", "values"]
    for name in ("items", "n_seen", "values"):
        w = np.asarray(want[name])
        g = got[name].numpy()
        if name == "items":
            assert w.dtype == np.uint32 and g.dtype == np.int32
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _jstate(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _batch(rng, t, n_rows=None):
    """Items up to 2**32 - 1 (a seventh at 2**31 and above), float
    values, a fifth masked; with ``n_rows`` also rows in [-1, n_rows]."""
    items = rng.randint(0, 2**32, t, dtype=np.int64).astype(np.uint32)
    items[::7] = rng.randint(2**31, 2**32, items[::7].size)
    out = dict(items=items, vals=(rng.randn(t) * 3).astype(np.float32),
               mask=rng.rand(t) > 0.2)
    if n_rows is not None:
        syn = rng.randint(0, n_rows - 3, t).astype(np.int32)
        syn[::4] = 2                                  # a long run
        syn[::7] = -1                                 # unrouted
        syn[5::11] = n_rows                           # outside the stack
        syn[3::29] = 5                                # routed to a source
        out["syn"] = syn
    return out


@pytest.mark.smoke
@pytest.mark.parametrize("n0", COUNTS, ids=["n0", "n5", "n2e24", "top"])
@pytest.mark.parametrize("s", [1, 16, 64])
def test_add_batch_matches_jax(s, n0):
    """The one-row sampler over 500 tuples with masked gaps and items of
    2**31 and above, from a count of 0 (the fill), 5, just under 2**24
    and 2**31 - 2T, then again from the state it left."""
    jk = jsampler.ReservoirSampler(sample_size=s)
    tk = tsampler.ReservoirSampler(sample_size=s)
    assert tk.memory_bytes() == jk.memory_bytes()
    rng = np.random.RandomState(s + n0 % 1000)
    js, ts = jk.init(), tk.init("cpu")
    _same_state(ts, js)
    js["n_seen"] = jnp.int32(n0)
    ts["n_seen"].fill_(n0)
    for _ in range(2):
        x = _batch(rng, T)
        js = jk.add_batch(js, jnp.asarray(x["items"]), jnp.asarray(x["vals"]),
                          jnp.asarray(x["mask"]))
        assert tk.add_batch(ts, _t(x["items"]), _t(x["vals"]),
                            _t(x["mask"])) is ts
        _same_state(ts, js)
    assert int(ts["n_seen"]) > n0


def _sample_states(jk, rng):
    """Reference states: empty, part filled, full, past the fill."""
    states = []
    for n0, t in ((0, 0), (0, jk.sample_size // 2), (0, jk.sample_size),
                  (5000, 300), (2**24 - 100, 200)):
        s = jk.init()
        s["n_seen"] = jnp.int32(n0)
        x = _batch(rng, t)
        s = jk.add_batch(s, jnp.asarray(x["items"]), jnp.asarray(x["vals"]),
                         jnp.ones(t, bool))
        states.append({k: np.asarray(v) for k, v in s.items()})
    return states


@pytest.mark.parametrize("s", [1, 16, 64])
def test_queries_and_merge_match_jax(s):
    """``estimate`` and the stacked estimate of a row batch (values,
    uint32 items, valid) and ``merge`` of states empty, part filled, full
    and past the fill, each on the reference's own states."""
    jk = jsampler.ReservoirSampler(sample_size=s)
    tk = tsampler.ReservoirSampler(sample_size=s)
    states = _sample_states(jk, np.random.RandomState(s))
    t_states = [{k: _t(v) for k, v in st.items()} for st in states]
    for js, ts in zip(states, t_states):
        _same({k: np.asarray(v) for k, v in jk.estimate(_jstate(js)).items()},
              {k: v.numpy() for k, v in tk.estimate(ts).items()})
    stack = {k: np.stack([st[k] for st in states]) for k in states[0]}
    rows = np.asarray([2, 0, 4, 2, 1, 3], np.int32)
    got = tk.stacked_estimate({k: _t(v) for k, v in stack.items()},
                              _t(rows))
    want = jk.stacked_estimate(_jstate(stack), jnp.asarray(rows))
    assert sorted(got) == ["items", "valid", "values"]
    assert got["items"].dtype == torch.uint32
    _same({k: np.asarray(v) for k, v in want.items()},
          {k: v.numpy() for k, v in got.items()})
    assert int(got["items"].numpy().max()) >= 2**31   # stays positive
    for a, b in ((0, 1), (1, 2), (3, 0), (4, 3), (2, 2)):
        _same_state(tk.merge(t_states[a], t_states[b]),
                    jk.merge(_jstate(states[a]), _jstate(states[b])))


@pytest.mark.parametrize("sources", [None, [5], [5, 11, 5]],
                         ids=["no_source", "one_source", "repeated_source"])
@pytest.mark.parametrize("s", [16, 64])
def test_stacked_update_matches_jax_vmap(s, sources):
    """``batched.stacked_update``'s scan branch (the kernel wrapper's plain
    version on the CPU) against the reference's vmap of ``add_batch``:
    rows -1 and n, a run of a quarter of the batch, untouched rows,
    data-source rows (one of them also routed to, one listed twice), rows
    starting at counts from 0 to 2**31 - 4T, over two batches; and
    ``ref.reservoir_scan_update`` called directly."""
    jk = jcore.make_kind("chain_sampler", sample_size=s)
    tk = tcore.make_kind("chain_sampler", sample_size=s)
    n = 16
    rng = np.random.RandomState(s + (0 if sources is None else len(sources)))
    n0 = rng.choice([0, 3, s - 1, s, 40 * s, 2**24 - 10, 2**31 - 4 * T],
                    n).astype(np.int32)
    jstate = jbatched.stacked_init(jk, n)
    jstate["n_seen"] = jnp.asarray(n0)
    tstate = tbatched.stacked_init(tk, n, "cpu")
    tstate["n_seen"].copy_(_t(n0))
    direct = tbatched.tree_map(torch.clone, tstate)
    src = None if sources is None else np.asarray(sources, np.int32)
    before = reservoir_scan.reservoir_scan_update.launches
    for _ in range(2):
        x = _batch(rng, T, n)
        jstate = jbatched.stacked_update(
            jk, jstate, jnp.asarray(x["syn"]), jnp.asarray(x["items"]),
            jnp.asarray(x["vals"]), jnp.asarray(x["mask"]),
            None if src is None else jnp.asarray(src))
        args = (_t(x["syn"]), _t(x["items"]), _t(x["vals"]), _t(x["mask"]),
                None if src is None else _t(src).long())
        assert tbatched.stacked_update(tk, tstate, *args) is tstate
        ref.reservoir_scan_update(direct["values"], direct["items"],
                                  direct["n_seen"], *args, seed=tk.seed)
        _same_state(tstate, jstate)
        _same_state(direct, jstate)
    assert reservoir_scan.reservoir_scan_update.launches == before
    for name in ("values", "items"):           # rows n-3.. untouched
        assert not tstate[name][n - 3:].any(), name
    assert np.array_equal(tstate["n_seen"][n - 3:].numpy(), n0[n - 3:])


def _registry_inputs(seed, s, sources, t=900):
    """A stack of 32 rows at counts 0 to past 2**24, and a batch of stream
    ids on a 64-slot routing table whose first 6 ids share a start slot
    (displaced 0-5 slots, beyond ``n_probe`` = 2 for the last 3): Zipf-hot
    routed ids, ids not in the table, negative ids (masked, as ingest masks
    them) and a fifth masked, items past 2**31; ``sources`` data-source
    rows, the first of them also routed to."""
    rng = np.random.RandomState(seed)
    cand = np.arange(1, 200000, dtype=np.int64)
    home = routing.slot_hash(*routing.split64(cand), 64)
    cluster = cand[home == home[0]][:6]
    pop = np.concatenate([cluster, rng.randint(2**40, 2**62, 24,
                                               dtype=np.int64)])
    table = routing.RouteTable(64)
    table.insert_many(pop, np.arange(len(pop), dtype=np.int32))
    assert table.size == 64 and table.max_probe >= 6
    n = len(pop) + 2
    p = 1.0 / np.arange(1, len(pop) + 1) ** 1.1
    sids = pop[rng.choice(len(pop), t, p=p / p.sum())]
    sids[::23] = cluster[rng.randint(0, 6, sids[::23].size)]
    sids[::13] = rng.randint(2**62, 2**63 - 1, sids[::13].size,
                             dtype=np.int64)             # not in the table
    sids[5::41] = -7                                     # negative
    items = routing.fold64(sids)
    items[::9] |= np.uint32(2**31)
    mask = (rng.rand(t) > 0.2) & (sids >= 0)
    vals = (rng.randn(t) * 3).astype(np.float32)
    n0 = rng.choice([0, 3, s - 1, s, 40 * s, 2**24 - 10], n).astype(np.int32)
    full = n0[:, None] > np.arange(s)[None, :]
    state = dict(values=np.where(full, rng.randn(n, s), 0).astype(np.float32),
                 items=np.where(full, rng.randint(0, 2**32, (n, s)),
                                0).astype(np.uint32),
                 n_seen=n0)
    klo, khi = routing.split64(table.keys)
    slo, shi = routing.split64(sids)
    src = None if sources is None else np.asarray(sources, np.int32)
    return dict(table=(klo, khi, table.rows), sids=(slo, shi), items=items,
                vals=vals, mask=mask, src=src, state=state, n_probe=2,
                pop=pop)


@pytest.mark.parametrize("sources", [None, [3, 31, 3]],
                         ids=["no_source", "sources"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_registry_update_matches_jax_probe_and_vmap(fuse, sources):
    """The registry's sampler update (``resolve_update_kernel``: the fused
    entry, or the plain probe ahead of the rows-given one) over two
    batches, byte for byte against the JAX package's probe plus its vmapped
    ``stacked_update`` and against the port's ``route_probe`` plus
    ``batched.stacked_update``: ids displaced beyond ``n_probe``, ids not
    in the table and negative ids take no row, hot rows take runs of many
    tuples, data-source rows every masked tuple."""
    s = 16
    jk = jcore.make_kind("chain_sampler", sample_size=s)
    tk = tcore.make_kind("chain_sampler", sample_size=s)
    assert tk.update_kernel == "reservoir_scan"
    x = _registry_inputs(3 + (sources is None), s, sources)
    jstate = _jstate(x["state"])
    tstate = {k: _t(v) for k, v in x["state"].items()}
    plain = {k: v.clone() for k, v in tstate.items()}
    fn = tops.resolve_update_kernel(tk, fuse)
    before = (reservoir_scan.reservoir_scan_update.launches,
              reservoir_scan.reservoir_probe_scan_update.launches)
    for _ in range(2):
        jargs = [jnp.asarray(a) for a in (*x["table"], *x["sids"])]
        rows = jops.route_probe(*jargs, n_probe=x["n_probe"])
        jstate = jbatched.stacked_update(
            jk, jstate, rows, jnp.asarray(x["items"]), jnp.asarray(x["vals"]),
            jnp.asarray(x["mask"]),
            None if x["src"] is None else jnp.asarray(x["src"]))
        targs = [_t(a) for a in (*x["table"], *x["sids"], x["items"],
                                 x["vals"], x["mask"])]
        src = None if x["src"] is None else _t(x["src"]).long()
        assert fn(tstate, *targs, src, n_probe=x["n_probe"]) is tstate
        trows = tops.route_probe(*targs[:5], n_probe=x["n_probe"])
        assert np.array_equal(trows.numpy(), np.asarray(rows))
        tbatched.stacked_update(tk, plain, trows, *targs[5:], src)
        _same_state(tstate, jstate)
        _same_state(plain, jstate)
    assert (reservoir_scan.reservoir_scan_update.launches,
            reservoir_scan.reservoir_probe_scan_update.launches) == before
    rows = np.asarray(rows)
    sid64 = (x["sids"][1].astype(np.int64) << 32) | x["sids"][0]
    known = np.isin(sid64, x["pop"])
    assert ((rows == -1) & known).sum() > 0              # displaced
    assert ((rows == -1) & ~known & (sid64 >= 0)).sum() > 0
    assert (sid64 < 0).sum() > 0
    routed = rows[x["mask"] & (rows >= 0)]
    assert np.bincount(routed).max() > 64                 # runs over warps
    n_seen = tstate["n_seen"].numpy()
    spare = len(x["pop"])                                  # no id, no source
    assert n_seen[spare] == x["state"]["n_seen"][spare]
    if sources is not None:                  # every masked tuple, twice
        assert n_seen[31] == x["state"]["n_seen"][31] + 2 * x["mask"].sum()


def _model_scan(state, batch, seed):
    """A test-only model of the reservoir kernel's order of operations
    (``csrc/reservoir_scan.cu``): the key pass (routed tuples of source
    rows dropped), the stable sort, each run's start and end; every
    (walk, tuple) pair's rank (a sorted position less its run's start, a
    source walk's masked tuples before), then its slot; then each slot's
    last writer, first within each 32 positions (a warp), stored at once
    for a run within them, else the largest (rank + 1, tuple) over the
    warps of a walk keyed as the kernel keys it (a crossing run by the
    32-position chunk it starts in, a source row past the chunks), stored
    last with the counts. Returns the stack (numpy) and the paths taken."""
    values, items, n_seen = (x.numpy().copy() for x in state)
    rows, in_items, vals, mask, src = (
        None if x is None else x.numpy() for x in batch)
    n, s = values.shape
    t = len(rows)
    srcs, seen = [], set()
    for i, r in enumerate([] if src is None else src.tolist()):
        if 0 <= r < n and r not in seen:
            srcs.append((i, r))
            seen.add(r)
    flag = np.zeros(n, bool)
    flag[[r for _, r in srcs]] = True
    keep = mask & (rows >= 0) & (rows < n)
    keep[keep] &= ~flag[rows[keep]]
    kept = np.nonzero(keep)[0]
    order = np.argsort(rows[kept], kind="stable")
    srow, perm = rows[kept][order], kept[order]
    start, end = {}, {}
    for p, r in enumerate(srow.tolist()):
        start.setdefault(r, p)
        end[r] = p + 1
    best, paths = {}, collections.Counter()
    paths["runs across warps"] = sum(start[r] // 32 != (end[r] - 1) // 32
                                     for r in start)
    chunks = (t + 31) // 32
    n0 = n_seen.copy()

    def slot(count, tt):
        return _reservoir_step(count, in_items[tt].view(np.uint32), s, seed)

    for c in range((len(srow) + 31) // 32):
        last = {}
        for p in range(32 * c, min(32 * c + 32, len(srow))):
            r = int(srow[p])
            j, write = slot(int(n0[r]) + p - start[r], perm[p])
            if write:
                last[(r, j)] = p                     # the later lane wins
        for (r, j), p in last.items():
            tt, rank = perm[p], p - start[r]
            if start[r] // 32 == (end[r] - 1) // 32:
                values[r, j], items[r, j] = vals[tt], in_items[tt]
                paths["within a warp"] += 1
            else:
                key = (start[r] // 32, j)
                best[key] = max(best.get(key, (0, 0)), (rank + 1, tt))
                paths["across warps"] += 1
    before = np.concatenate([[0], np.cumsum(mask)])
    for i, r in srcs:
        for c in range(chunks):
            last = {}
            for tt in range(32 * c, min(32 * c + 32, t)):
                if mask[tt]:
                    j, write = slot(int(n0[r]) + int(before[tt]), tt)
                    if write:
                        last[j] = tt
            for j, tt in last.items():
                key = (chunks + i, j)
                best[key] = max(best.get(key, (0, 0)),
                                (int(before[tt]) + 1, tt))
                paths["source"] += 1
    src_row = dict(srcs)
    for (w, j), (_, tt) in best.items():
        r = srow[32 * w + 31] if w < chunks else src_row[w - chunks]
        values[r, j], items[r, j] = vals[tt], in_items[tt]
    for r in end:
        n_seen[r] += end[r] - start[r]
    for _, r in srcs:
        n_seen[r] += int(mask.sum())
    return (values, items, n_seen), paths


@pytest.mark.parametrize("n,s,t,sources,pattern", _RESERVOIR_CASES)
def test_kernel_order_matches_the_per_tuple_loop(n, s, t, sources, pattern):
    """The reservoir kernel's order of operations (``_model_scan``: ranks,
    slots of every pair at once, each slot's last writer within a warp,
    then across warps by the largest rank) byte for byte against the
    per-tuple loop (``ref.reservoir_scan_update``, held to the
    reference's vmap above) on every card case; the runs within a warp,
    those across warps and the source walks each take their path."""
    rng = np.random.RandomState(n + s + t)
    state, batch = _reservoir_case(rng, n, s, t, sources, pattern, "cpu")
    got, paths = _model_scan(state, batch, RESERVOIR_SEED)
    want = [x.clone() for x in state]
    ref.reservoir_scan_update(*want, *batch, seed=RESERVOIR_SEED)
    for g, w in zip(got, want):
        assert g.tobytes() == w.numpy().tobytes()
    short = n > t // 8 and t >= 32              # many runs of few tuples
    if pattern == "empty" or short:          # runs that write, of each kind
        kinds = ["within a warp"] if short else []
        kinds += ["across warps"] if paths["runs across warps"] else []
        kinds += ["source"] if sources else []
        assert all(paths[k] > 0 for k in kinds), dict(paths)


def _sampler_requests(rng, ids, extra, n_batches=3, t=300):
    reqs = [
        {"type": "build", "request_id": "b-rs", "synopsis_id": "rs",
         "kind": "chain_sampler", "per_stream_of_source": True,
         "stream_ids": ids[:40]},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-rs",
         "kind": "chain_sampler"},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-rs",
         "kind": "chain_sampler", "continuous": True},
        {"type": "build", "request_id": "b-one", "synopsis_id": "one",
         "kind": "chain_sampler", "params": {"sample_size": 16},
         "stream_id": extra},
    ]
    pop = np.asarray(ids, np.int64)
    for b in range(n_batches):
        if b == 1:      # the per-stream stack grows past 64 rows
            reqs.append({"type": "build", "request_id": "b-more",
                         "synopsis_id": "rs2", "kind": "chain_sampler",
                         "per_stream_of_source": True,
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


def test_engine_json_flow_matches_jax_engine(monkeypatch):
    """Per-stream (growing past 64 rows), data-source, continuous and
    single-stream (sample_size 16) samplers through ``SDE.handle``: the
    same JSON responses (items of 2**31 and above as the same positive
    numbers), states, continuous emissions and status; each per-stream
    sample holds only its own folded id; then stop, rebuild (an empty
    sample) and a converted engine that keeps ingesting like the
    reference. Every ingest takes the registry route, the probe fused
    into the reservoir update (its plain version here)."""
    fused = reservoir_scan.reservoir_probe_scan_update
    calls = collections.Counter()

    def spy(*args, **kwargs):
        calls["fused"] += 1
        return fused(*args, **kwargs)

    monkeypatch.setattr(reservoir_scan, "reservoir_probe_scan_update", spy)
    monkeypatch.setenv("SDE_FUSED_PROBE", "1")
    rng = np.random.RandomState(41)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=70,
                                                 dtype=np.int64))]
    ids = [0] + ids[:69]
    extra = int(rng.randint(0, 2**62))
    reqs = _sampler_requests(rng, ids, extra)
    reqs += [
        {"type": "adhoc", "request_id": "q-rs", "synopsis_id": f"rs/{ids[2]}"},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-rs"},
        {"type": "adhoc", "request_id": "q-one", "synopsis_id": "one"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"rs/{i}"} for i in ids[:40]] + [
            {"synopsis_id": f"rs2/{i}"} for i in ids[40:]] + [
            {"synopsis_id": "src-rs"}, {"synopsis_id": "one"},
            {"synopsis_id": "cq-rs", "query": {"items": "ignored"}},
            {"synopsis_id": "nope"}, 5]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "rs"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "rs",
         "kind": "chain_sampler", "per_stream_of_source": True,
         "stream_ids": ids[:40]},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"rs/{ids[2]}"},
        {"type": "flush", "request_id": "fl"},
    ]
    je, te = JaxSDE(), TorchSDE(device="cpu")
    before = tops.DISPATCH_COUNT["update:ReservoirSampler"]
    answers, big = {}, 0
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
                       for q, v in zip(r["queries"][:-2], rb.value)}
            assert ra.to_json() == rb.to_json()
        elif ra.ok:
            _same(ra.value, rb.value)
            if r["type"] != "status":       # the port's status adds device
                assert ra.to_json() == rb.to_json(), r["request_id"]
            else:
                assert ra.value == rb.value
        if isinstance(rb.value, dict) and "items" in rb.value:
            big += int((rb.value["items"] >= 2**31).sum())
    assert big > 0                            # ids past 2**31 answered
    n_ingest = sum(q["type"] == "ingest" for q in reqs)
    assert tops.DISPATCH_COUNT["update:ReservoirSampler"] - before == \
        2 * n_ingest                # two kind stacks: S = 64 and 16
    assert calls["fused"] == 2 * n_ingest
    own = dict(zip(ids, routing.fold64(np.asarray(ids, np.int64)).tolist()))
    seen = 0
    for i in ids:
        a = answers[f"rs/{i}" if i in ids[:40] else f"rs2/{i}"]
        held = a["items"][a["valid"]]
        assert a["items"].dtype == np.uint32
        assert set(held.tolist()) <= {own[i]}
        seen += held.size > 0
    assert seen > 20
    src = answers["src-rs"]
    assert src["valid"].all() and np.array_equal(
        src["items"], answers["cq-rs"]["items"])
    r = te.handle({"type": "adhoc", "request_id": "z",
                   "synopsis_id": f"rs/{ids[2]}"})
    assert r.ok and not r.value["valid"].any()
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        _same_state(te.state_of(sid), je.state_of(sid))
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
    for r in _sampler_requests(rng, ids, extra, n_batches=2)[4:]:
        if r["type"] == "ingest":
            assert je.handle(dict(r)).ok and tc.handle(dict(r)).ok
    for sid in je.entries:
        state = tc.state_of(sid)
        assert state["items"].dtype == torch.int32
        _same_state(state, je.state_of(sid))
    q = {"type": "query_many", "request_id": "qc", "queries": [
        {"synopsis_id": s} for s in ("src-rs", "one", f"rs/{ids[5]}",
                                     "cq-rs")]}
    ra, rb = je.handle(dict(q)), tc.handle(dict(q))
    assert ra.to_json() == rb.to_json()


def test_reference_stack_carries_across():
    """A reference engine's sampler stack (uint32 ``items``, int32
    ``n_seen``, float32 ``values``) restores into the port through
    ``engine_from_contents``, items as their int32 bits, and answers as
    the reference does."""
    rng = np.random.RandomState(7)
    ids = [int(s) for s in rng.randint(0, 2**63 - 1, 12, dtype=np.int64)]
    je = JaxSDE()
    assert je.handle({"type": "build", "request_id": "b", "synopsis_id": "rs",
                      "kind": "chain_sampler",
                      "params": {"sample_size": 8},
                      "per_stream_of_source": True,
                      "stream_ids": ids}).ok
    assert je.handle({"type": "build", "request_id": "c",
                      "synopsis_id": "src", "kind": "chain_sampler",
                      "params": {"sample_size": 8}}).ok
    for _ in range(2):
        sids = np.asarray(ids, np.int64)[rng.randint(0, 12, 200)]
        je.ingest(sids, rng.randn(200).astype(np.float32))
    contents = jax_contents(je)
    (stack,) = contents["stacks"]
    assert stack["state"]["items"].dtype == np.uint32
    assert int(stack["state"]["items"].max()) >= 2**31
    tc = engine_from_contents(contents, device="cpu")
    state = tc.stacks[tcore.make_kind("chain_sampler", sample_size=8)].state
    assert state["items"].dtype == torch.int32
    assert state["n_seen"].dtype == torch.int32
    for sid in je.entries:
        _same_state(tc.state_of(sid), je.state_of(sid))
    q = {"type": "query_many", "request_id": "q", "queries": [
        {"synopsis_id": "src"}] + [{"synopsis_id": f"rs/{i}"} for i in ids]}
    ra, rb = je.handle(dict(q)), tc.handle(dict(q))
    assert ra.to_json() == rb.to_json()


def test_init_needs_a_device_and_the_wrapper_refuses_other_devices():
    """``init`` and ``stacked_init`` take no default device; ``grow``
    pads new rows with empty reservoirs; the kind is arg-free on the red
    path and its status reports its parameters; a wrapper given tensors
    on neither the CPU nor a card raises instead of running its plain
    version."""
    kind = tcore.make_kind("chain_sampler", sample_size=16)
    assert tcore.kind_params(kind) == {"sample_size": 16, "seed": 41}
    assert not hasattr(kind, "stacked_add_batch")
    assert not hasattr(kind, "step")          # not a time-series kind
    with pytest.raises(TypeError):
        kind.init()
    with pytest.raises(TypeError):
        tbatched.stacked_init(kind, 4)
    stack = tbatched.stacked_init(kind, 2, "cpu")
    stack["n_seen"][:] = 3
    grown = tbatched.grow(kind, stack, 8)
    assert grown["values"].shape == (8, 16) and grown["n_seen"].shape == (8,)
    _same_state({k: v[2:] for k, v in grown.items()},
                {k: np.asarray(v) for k, v in jbatched.stacked_init(
                    jcore.make_kind("chain_sampler", sample_size=16),
                    6).items()})
    meta = {k: v.to("meta") for k, v in grown.items()}
    t = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        reservoir_scan.reservoir_scan_update(
            meta["values"], meta["items"], meta["n_seen"], t, t,
            t.to(torch.float32), t.to(torch.bool), seed=41)
