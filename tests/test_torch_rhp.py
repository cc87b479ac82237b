"""RHP (SimHash) in the port against the JAX package: the kind
(``core/rhp.py``), the kernel entry points through ``ops.rhp_update`` and
the update-kernel registry (the Pallas kernels in interpret mode), and the
engine's JSON flow through ``SDE.handle`` in both packages.

Integer weights (and every signature, Hamming weight and bucket) agree
byte for byte: with +-1 signs the float sums of integers are exact. Float
weights agree to ``rtol=1e-5, atol=1e-4``: the reference's one-hot matmul
and the port's sequential add take the same terms in another order."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.core import hashing as jhashing
from repro.core import rhp as jrhp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.service import SDE as JaxSDE
from repro.service import routing as jrouting
from test_torch_convert import jax_contents
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.core import rhp as trhp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref, rhp_project
from repro_torch.service import SDE as TorchSDE

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want, exact):
    if exact:
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _weights(rng, t, float_weights):
    return (rng.randn(t) * 3 if float_weights
            else rng.randint(-4, 5, t)).astype(np.float32)


@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("t,n,b", [(100, 3, 64), (700, 130, 64),
                                   (513, 16, 200)])
def test_rhp_update_matches_pallas(t, n, b, float_weights):
    """``ops.rhp_update`` in both packages, ``syn`` holding -1, with two
    data-source rows fed by the batch's summed projection."""
    rng = np.random.RandomState(t + b)
    state0 = (rng.randn(n, b) if float_weights
              else rng.randint(-3, 4, (n, b))).astype(np.float32)
    syn = rng.randint(-1, n, t).astype(np.int32)
    items = rng.randint(0, 10**6, t).astype(np.uint32)
    vals = _weights(rng, t, float_weights)
    mask = rng.rand(t) > 0.2
    src = np.asarray([0, n - 1], np.int32)
    seeds = jhashing.row_seeds(29, b)
    want = np.asarray(jops.rhp_update(
        jnp.asarray(state0), jnp.asarray(syn), jnp.asarray(items),
        jnp.asarray(vals), jnp.asarray(mask), seeds=jnp.asarray(seeds),
        source_rows=jnp.asarray(src)))
    state = _t(state0.copy())
    got = tops.rhp_update(state, _t(syn), _t(items.view(np.int32)),
                          _t(vals), _t(mask), seeds=_t(seeds.astype(np.int64)),
                          source_rows=_t(src).long())
    assert got.data_ptr() == state.data_ptr()             # in place
    _check(got.numpy(), want, not float_weights)


@pytest.mark.smoke
def test_rhp_plain_matches_jax_oracle_and_drops_out_of_range_rows():
    """``ref.rhp_project_update`` against ``repro/kernels/ref.py`` (which
    zeroes a -1 tuple's value rather than wrapping it), and rows past n
    dropped as -1 is; the fused plain version probes first."""
    rng = np.random.RandomState(2)
    n, b, t = 7, 40, 300
    syn = rng.randint(-1, n, t).astype(np.int32)
    vals = rng.randint(1, 5, t).astype(np.float32)
    signs = np.where(rng.rand(t, b) > 0.5, 1.0, -1.0).astype(np.float32)
    state0 = rng.randint(0, 3, (n, b)).astype(np.float32)
    want = np.asarray(jref.rhp_project_update(
        jnp.asarray(state0), jnp.asarray(syn), jnp.asarray(vals),
        jnp.asarray(signs)))
    got = rhp_project.rhp_project_update(_t(state0.copy()), _t(syn),
                                         _t(vals), _t(signs))
    assert np.array_equal(got.numpy(), want)
    past = np.where(syn < 0, n + 3, syn).astype(np.int32)
    got = ref.rhp_project_update(_t(state0.copy()), _t(past), _t(vals),
                                 _t(signs))
    assert np.array_equal(got.numpy(), want)
    assert rhp_project.rhp_project_update.one_row_launches == 0


@pytest.mark.parametrize("n,t,hot", [(5, 0, 0), (50, 300, 0),
                                     (8, 3000, 0), (131, 20000, 1.1),
                                     (2, 700, 0)])
def test_long_runs_of_matches_numpy(n, t, hot):
    """``rhp_project.long_runs_of`` (the runs the ring walk takes, and the
    longest add chain) against a numpy count of each kept row's tuples,
    with rows -1 and n dropped; ``hot`` draws the rows from a Zipf law."""
    rng = np.random.RandomState(n + t)
    if hot:
        p = 1.0 / np.arange(1, n + 1) ** hot
        rows = rng.choice(n, t, p=p / p.sum())
    else:
        rows = rng.randint(0, n, t)
    rows = np.where(rng.rand(t) < 0.1, rng.choice([-1, n], t), rows)
    rows = rows.astype(np.int32)
    kept = rows[(rows >= 0) & (rows < n)]
    counts = np.bincount(kept, minlength=n)
    want = (int((counts >= rhp_project.LONG_RUN).sum()),
            int(counts.max()) if kept.size else 0)
    assert rhp_project.long_runs_of(_t(rows), n) == want
    if t >= 3000:
        assert want[0] > 0


def _routed_inputs(seed, n=24, t=300, float_weights=False):
    rng = np.random.RandomState(seed)
    pop = np.unique(rng.randint(0, 2**62, size=4 * n, dtype=np.int64))[:n]
    table = jrouting.RouteTable()
    table.insert_many(pop, np.arange(n, dtype=np.int32))
    sids = pop[rng.randint(0, n, t)]
    sids[::13] = int(pop.max()) + 7          # unrouted: must be dropped
    return dict(table=table, sids=sids, n=n,
                vals=_weights(rng, t, float_weights), msk=rng.rand(t) > 0.2,
                src=np.asarray([1, 5], np.int32),
                n_probe=jrouting.next_pow2(table.max_probe))


def _args(x, as_torch):
    klo, khi = jrouting.split64(x["table"].keys)
    slo, shi = jrouting.split64(x["sids"])
    items = jrouting.fold64(x["sids"])
    if not as_torch:
        return tuple(jnp.asarray(a) for a in (
            klo, khi, x["table"].rows, slo, shi, items, x["vals"], x["msk"],
            x["src"]))
    return (_t(klo.view(np.int32)), _t(khi.view(np.int32)),
            _t(x["table"].rows), _t(slo.view(np.int32)),
            _t(shi.view(np.int32)), _t(items.view(np.int32)), _t(x["vals"]),
            _t(x["msk"]), _t(x["src"]).long())


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("n_bits", [64, 56])
def test_registry_update_matches_pallas_and_stacked_update(n_bits,
                                                           float_weights,
                                                           fuse):
    jkind = jcore.make_kind("rhp", n_bits=n_bits)
    tkind = tcore.make_kind("rhp", n_bits=n_bits)
    x = _routed_inputs(3, float_weights=float_weights)
    ja, ta = _args(x, False), _args(x, True)
    state0 = np.asarray(jbatched.stacked_init(jkind, x["n"]))
    pallas = np.asarray(jops.resolve_update_kernel(jkind, fuse)(
        jnp.asarray(state0), *ja, n_probe=x["n_probe"]))
    rows = jops.route_probe(*ja[:5], n_probe=x["n_probe"])
    xla = np.asarray(jbatched.stacked_update(jkind, jnp.asarray(state0),
                                             rows, *ja[5:]))
    exact = not float_weights
    state = torch.from_numpy(state0.copy())
    out = tops.resolve_update_kernel(tkind, fuse)(state, *ta,
                                                  n_probe=x["n_probe"])
    assert out.data_ptr() == state.data_ptr()
    _check(out.numpy(), pallas, exact)
    _check(out.numpy(), xla, exact)
    # the other entry point, and the port's plain kind-level update
    other = tops.resolve_update_kernel(tkind, not fuse)(
        torch.from_numpy(state0.copy()), *ta, n_probe=x["n_probe"])
    _check(other.numpy(), out.numpy(), exact)
    trows = tops.route_probe(*ta[:5], n_probe=x["n_probe"])
    plain = tbatched.stacked_update(tkind, torch.from_numpy(state0.copy()),
                                    trows, *ta[5:])
    _check(plain.numpy(), xla, exact)


def test_kind_estimates_and_cosine_similarity_match_jax():
    rng = np.random.RandomState(4)
    jk, tk = jrhp.RHP(n_bits=48, bucket_bits=6), trhp.RHP(n_bits=48,
                                                           bucket_bits=6)
    t = 400
    items = rng.randint(0, 10**6, t).astype(np.uint32)
    vals = rng.randint(1, 4, t).astype(np.float32)
    mask = rng.rand(t) > 0.1
    js = jk.add_batch(jk.init(), jnp.asarray(items), jnp.asarray(vals),
                      jnp.asarray(mask))
    ts = tk.add_batch(tk.init("cpu"), _t(items.view(np.int32)), _t(vals),
                      _t(mask))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    for key, want in jk.estimate(js).items():
        _check(tk.estimate(ts)[key].numpy(), np.asarray(want), True)
    stack = rng.randint(-5, 6, (9, 48)).astype(np.float32)
    rows = np.asarray([3, 0, 8, 3], np.int32)
    jest = jk.stacked_estimate(jnp.asarray(stack), jnp.asarray(rows))
    test = tk.stacked_estimate(_t(stack), _t(rows))
    for key, want in jest.items():
        _check(test[key].numpy(), np.asarray(want), True)
    sig_a, sig_b = jest["signature"][0], jest["signature"][1:]
    want = np.asarray(jrhp.cosine_similarity(sig_a, sig_b, 48))
    got = trhp.cosine_similarity(test["signature"][0],
                                 test["signature"][1:], 48).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tk.memory_bytes() == jk.memory_bytes()
    np.testing.assert_array_equal(
        tk.merge(_t(stack[0]), _t(stack[1])).numpy(),
        np.asarray(jk.merge(jnp.asarray(stack[0]), jnp.asarray(stack[1]))))


def _rhp_requests(rng, ids, extra, n_batches=3, t=257):
    reqs = [
        {"type": "build", "request_id": "b-rhp", "synopsis_id": "rhp",
         "kind": "rhp", "per_stream_of_source": True, "stream_ids": ids},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-rhp",
         "kind": "rhp"},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-rhp",
         "kind": "rhp", "stream_id": extra, "continuous": True},
        {"type": "build", "request_id": "b-narrow", "synopsis_id": "narrow",
         "kind": "rhp", "params": {"n_bits": 200, "bucket_bits": 4},
         "per_stream_of_source": True, "stream_ids": ids[:5]},
    ]
    pop = np.asarray(ids, np.int64)
    for b in range(n_batches):
        sids = pop[rng.randint(0, len(pop), t)].copy()
        sids[::9] = extra
        sids[::11] = int(rng.randint(0, 2**62)) | 1   # unrouted
        sids[::17] = -3                               # negative: masked
        reqs.append({"type": "ingest", "request_id": f"i{b}",
                     "stream_ids": [int(s) for s in sids],
                     "values": rng.randint(-2, 5, t).tolist()})
    return reqs


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_engine_json_flow_matches_jax_engine(monkeypatch, fused):
    """Per-stream, data-source and continuous RHP through ``SDE.handle``:
    the same responses (signatures, Hamming weights and buckets byte for
    byte), the same state, the same continuous emissions; then stop,
    rebuild (reads all zeros) and a converted engine that keeps
    ingesting like the reference."""
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    rng = np.random.RandomState(9)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=24,
                                                 dtype=np.int64))]
    extra = int(rng.randint(0, 2**62))
    reqs = _rhp_requests(rng, ids, extra)
    reqs += [
        {"type": "adhoc", "request_id": "q-rhp",
         "synopsis_id": f"rhp/{ids[2]}"},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-rhp"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"rhp/{i}"} for i in ids[:6]] + [
            {"synopsis_id": "cq-rhp"}, {"synopsis_id": "narrow/" + str(ids[1])},
            {"synopsis_id": "src-rhp", "query": {"items": [1]}}, 5]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "rhp"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "rhp",
         "kind": "rhp", "per_stream_of_source": True, "stream_ids": ids},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"rhp/{ids[2]}"},
        {"type": "flush", "request_id": "fl"},
    ]
    je, te = JaxSDE(), TorchSDE(device="cpu")
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        assert (ra.request_id, ra.synopsis_id, ra.ok) == \
            (rb.request_id, rb.synopsis_id, rb.ok), (ra, rb)
        if isinstance(ra.value, list):
            for a, b in zip(ra.value, rb.value, strict=True):
                assert (a["request_id"], a["ok"]) == (b["request_id"],
                                                      b["ok"])
                _same(a["value"], b["value"])
        elif ra.ok:
            _same(ra.value, rb.value)
            if r["type"] != "status":       # the port's status adds device
                assert ra.to_json() == rb.to_json(), r["request_id"]
    again = te.handle({"type": "adhoc", "request_id": "z",
                       "synopsis_id": f"rhp/{ids[2]}"}).value
    assert not again["signature"].any() and again["hamming_weight"] == 0
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        want = np.asarray(je.state_of(sid))
        assert np.array_equal(te.state_of(sid).numpy(), want), sid
    src = np.asarray(je.state_of("src-rhp"))
    assert np.abs(src).sum() > 0                     # the fold fed it
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out] == \
        [f"cq/cq-rhp/{b}" for b in (1, 2, 3)]
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same(ra.value, rb.value)

    # carried into a fresh port engine: both keep ingesting alike
    tc = engine_from_contents(jax_contents(je), device="cpu")
    for r in _rhp_requests(rng, ids, extra, n_batches=2)[4:]:
        assert je.handle(dict(r)).ok and tc.handle(dict(r)).ok
    for sid in je.entries:
        state = tc.state_of(sid)
        assert state.dtype == torch.float32
        assert np.array_equal(state.numpy(), np.asarray(je.state_of(sid)))
