"""AMS (count-sketch) in the port against the JAX package: the kind
(``core/ams.py``) at depths 3, 7 and 12, its median against
``jnp.median``, the update-kernel registry (the Pallas kernels in
interpret mode), and the engine's JSON flow through ``SDE.handle`` in
both packages, then carried across by ``convert.engine_from_contents``.

Integer weights (and every median, estimate and answer over them) agree
byte for byte: with +-1 signs the float sums of integers stay exact below
2**24. Float weights agree to ``rtol=1e-5, atol=1e-4``: the reference's
scatter and the port's add the same terms in another order."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import ams as jams
from repro.core import batched as jbatched
from repro.kernels import ops as jops
from repro.service import SDE as JaxSDE
from repro.service import routing as jrouting
from test_torch_convert import jax_contents
from test_torch_rhp import _same
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import ams as tams
from repro_torch.core import batched as tbatched
from repro_torch.kernels import ops as tops
from repro_torch.service import SDE as TorchSDE

RTOL, ATOL = 1e-5, 1e-4
# (delta, eps) -> depth 3, 7 and 12 (the default) at widths 64, 512, 2048
PARAMS = [(0.5, 0.25), (0.2, 0.1), (0.05, 0.05)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _weights(rng, t, float_weights):
    return (rng.randn(t) * 3 if float_weights
            else rng.randint(-4, 5, t)).astype(np.float32)


@pytest.mark.smoke
def test_median_matches_jnp_median_where_torch_median_does_not():
    """At an even depth ``jnp.median`` averages the two middle rows and
    ``torch.median`` returns the lower one; the port's helper is
    ``jnp.median`` byte for byte, at odd depths too, including a midpoint
    whose sum rounds in float32."""
    rng = np.random.RandomState(1)
    even = np.array([[1.0, 8.0, 2.0, 4.0],
                     [3.0, -1.0, 2.0 ** 24 + 2.0, 2.0 ** 24]], np.float32)
    cases = [even,
             rng.randint(-50, 50, (9, 12)).astype(np.float32),
             rng.randint(-50, 50, (9, 7)).astype(np.float32),
             rng.randn(5, 3).astype(np.float32) * 1e3,
             (rng.randn(4, 12) * 1e6).astype(np.float32)]
    for x in cases:
        want = np.asarray(jnp.median(jnp.asarray(x), axis=-1))
        _check(tams.median_last(_t(x)).numpy(), want, True)
    lower = torch.median(_t(even), dim=-1).values.numpy()
    want = np.asarray(jnp.median(jnp.asarray(even), axis=-1))
    assert not np.array_equal(lower, want)
    assert want[0] == 3.0 and lower[0] == 2.0


@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("delta,eps", PARAMS)
def test_kind_methods_match_jax(delta, eps, float_weights):
    """Every method of the kind against ``repro.core.ams.AMS``: the
    shapes, one-row and stacked updates, ``add_dense``, the L2 and
    inner-product estimates, point queries on ingested and unseen items,
    merge and memory."""
    jk = jams.AMS(eps=eps, delta=delta)
    tk = tams.AMS(eps=eps, delta=delta)
    assert (tk.depth, tk.width, tk.log2_width) == (jk.depth, jk.width,
                                                   jk.log2_width)
    assert tk.depth == {0.5: 3, 0.2: 7, 0.05: 12}[delta]
    assert tk.memory_bytes() == jk.memory_bytes()
    assert np.array_equal(tk._seeds().numpy(), np.asarray(jk._seeds()))
    exact = not float_weights
    rng = np.random.RandomState(tk.depth)
    t, n = 300, 9
    items = rng.randint(0, 200, t).astype(np.uint32)     # repeats
    vals = _weights(rng, t, float_weights)
    mask = rng.rand(t) > 0.2
    ja = (jnp.asarray(items), jnp.asarray(vals), jnp.asarray(mask))
    ta = (_t(items.view(np.int32)), _t(vals), _t(mask))

    js = jk.add_batch(jk.init(), *ja)
    ts = tk.add_batch(tk.init("cpu"), *ta)
    _check(ts.numpy(), js, exact)

    syn = rng.randint(0, n, t).astype(np.int32)
    stack0 = rng.randint(-3, 4, (n, tk.depth, tk.width)).astype(np.float32)
    jstack = jk.stacked_add_batch(jnp.asarray(stack0), jnp.asarray(syn), *ja)
    tstack = _t(stack0.copy())
    assert tk.stacked_add_batch(tstack, _t(syn), *ta) is tstack
    _check(tstack.numpy(), jstack, exact)

    vec = _weights(rng, 700, float_weights)
    jd = jk.add_dense(jk.init(), jnp.asarray(vec))
    td = tk.add_dense(tk.init("cpu"), _t(vec))
    _check(td.numpy(), jd, exact)

    # the estimates, each on the reference's own state
    jstack = np.asarray(jstack)
    rows = np.asarray([3, 0, 8, 3, 5], np.int32)
    _check(tk.stacked_estimate(_t(jstack), _t(rows)).numpy(),
           jk.stacked_estimate(jnp.asarray(jstack), jnp.asarray(rows)),
           exact)
    js = np.asarray(js)
    _check(tk.estimate(_t(js)).numpy(), jk.estimate(jnp.asarray(js)), exact)
    _check(tk.inner_product(_t(js), _t(jstack[2])).numpy(),
           jk.inner_product(jnp.asarray(js), jnp.asarray(jstack[2])), exact)
    q = np.concatenate([items[:20], np.arange(10**6, 10**6 + 20)]).astype(
        np.uint32)
    _check(tk.point_query(_t(js), _t(q.view(np.int32))).numpy(),
           jk.point_query(jnp.asarray(js), jnp.asarray(q)), exact)
    _check(tk.merge(_t(js), _t(jstack[1])).numpy(),
           jk.merge(jnp.asarray(js), jnp.asarray(jstack[1])), True)


def test_point_query_and_l2_of_one_item_are_exact():
    """One item of total weight W in an empty sketch: every depth row
    holds +-W at one counter, so the point query is W and the L2 estimate
    W*W (float32), at the default even depth, in both packages."""
    jk, tk = jams.AMS(), tams.AMS()
    items = np.full(50, 123457, np.uint32)
    vals = np.arange(1, 51, dtype=np.float32)
    total = np.float32(vals.sum())
    ts = tk.add_batch(tk.init("cpu"), _t(items.view(np.int32)), _t(vals),
                      torch.ones(50, dtype=torch.bool))
    js = jk.add_batch(jk.init(), jnp.asarray(items), jnp.asarray(vals),
                      jnp.ones(50, bool))
    _check(ts.numpy(), js, True)
    assert tk.point_query(ts, _t(items[:1].view(np.int32))).item() == total
    assert tk.estimate(ts).numpy().tobytes() == (total * total).tobytes()
    assert np.asarray(jk.estimate(js)).tobytes() == (total * total).tobytes()


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
@pytest.mark.parametrize("delta,eps", PARAMS[:2])
def test_registry_update_matches_pallas_and_stacked_update(delta, eps,
                                                           float_weights,
                                                           fuse):
    """``ams_scatter`` in both registries (the reference's Pallas kernel in
    interpret mode), rows -1 and two data-source rows; the port's other
    entry point and its plain ``batched.stacked_update`` agree too."""
    jkind = jcore.make_kind("ams", eps=eps, delta=delta)
    tkind = tcore.make_kind("ams", eps=eps, delta=delta)
    assert "ams_scatter" in tops.UPDATE_KERNELS
    x = _routed_inputs(4, float_weights=float_weights)
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
    other = tops.resolve_update_kernel(tkind, not fuse)(
        torch.from_numpy(state0.copy()), *ta, n_probe=x["n_probe"])
    _check(other.numpy(), out.numpy(), exact)
    trows = tops.route_probe(*ta[:5], n_probe=x["n_probe"])
    plain = tbatched.stacked_update(tkind, torch.from_numpy(state0.copy()),
                                    trows, *ta[5:])
    _check(plain.numpy(), xla, exact)
    assert np.abs(pallas[x["src"]]).sum() > 0          # the fold fed them


def _ams_requests(rng, ids, extra, n_batches=3, t=257):
    reqs = [
        {"type": "build", "request_id": "b-ams", "synopsis_id": "ams",
         "kind": "ams", "per_stream_of_source": True, "stream_ids": ids},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-ams",
         "kind": "ams"},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-ams",
         "kind": "ams", "continuous": True},
        {"type": "build", "request_id": "b-cq1", "synopsis_id": "cq1-ams",
         "kind": "ams", "stream_id": extra, "continuous": True},
        {"type": "build", "request_id": "b-narrow", "synopsis_id": "narrow",
         "kind": "ams", "params": {"eps": 0.25, "delta": 0.2},
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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_engine_json_flow_matches_jax_engine(monkeypatch, fused):
    """Per-stream, data-source and continuous AMS (a data-source one and
    one on a stream) through ``SDE.handle``: the same responses byte for
    byte, the same state, the same continuous emissions; each per-stream
    answer is its stream's total weight squared; then stop, rebuild (reads
    0), status, and a converted engine that keeps ingesting like the
    reference."""
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    rng = np.random.RandomState(12)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=24,
                                                 dtype=np.int64))]
    extra = int(rng.randint(0, 2**62))
    reqs = _ams_requests(rng, ids, extra)
    reqs += [
        {"type": "adhoc", "request_id": "q-ams",
         "synopsis_id": f"ams/{ids[2]}"},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-ams"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"ams/{i}"} for i in ids] + [
            {"synopsis_id": "cq-ams"}, {"synopsis_id": "cq1-ams"},
            {"synopsis_id": "narrow/" + str(ids[1])},
            {"synopsis_id": "src-ams", "query": {"items": [1]}}, 5]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "ams"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "ams",
         "kind": "ams", "per_stream_of_source": True, "stream_ids": ids},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"ams/{ids[2]}"},
        {"type": "flush", "request_id": "fl"},
    ]
    je, te = JaxSDE(), TorchSDE(device="cpu")
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
                       for q, v in zip(r["queries"][:-1], rb.value)}
        elif ra.ok:
            _same(ra.value, rb.value)
            if r["type"] != "status":       # the port's status adds device
                assert ra.to_json() == rb.to_json(), r["request_id"]
    # each per-stream row only ever saw its own item
    ingests = [q for q in reqs[:8] if q["type"] == "ingest"]
    sids = np.concatenate([q["stream_ids"] for q in ingests])
    vals = np.concatenate([q["values"] for q in ingests]).astype(np.float32)
    for i in ids:
        total = np.float32(vals[sids == i].sum())
        got = np.asarray(answers[f"ams/{i}"])
        assert got.tobytes() == (total * total).tobytes()
    assert np.asarray(answers["cq-ams"]).tobytes() == \
        np.asarray(answers["src-ams"]).tobytes()
    assert te.handle({"type": "adhoc", "request_id": "z",
                      "synopsis_id": f"ams/{ids[2]}"}).value == 0.0
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        want = np.asarray(je.state_of(sid))
        _check(te.state_of(sid).numpy(), want, True)
    assert np.abs(np.asarray(je.state_of("src-ams"))).sum() > 0
    want_cq = [f"cq/{sid}/{b}" for b in (1, 2, 3)
               for sid in ("cq-ams", "cq1-ams")]
    assert sorted(r.request_id for r in te.continuous_out) == sorted(want_cq)
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same(ra.value, rb.value)
    assert te.memory_bytes() == sum(s.state.nbytes
                                    for s in je.stacks.values())

    # carried into a fresh port engine: both keep ingesting alike
    tc = engine_from_contents(jax_contents(je), device="cpu")
    for r in _ams_requests(rng, ids, extra, n_batches=2)[5:]:
        assert je.handle(dict(r)).ok and tc.handle(dict(r)).ok
    for sid in je.entries:
        state = tc.state_of(sid)
        assert state.dtype == torch.float32 and state.shape[-2:] in (
            (12, 2048), (7, 64))
        _check(state.numpy(), np.asarray(je.state_of(sid)), True)
    q = {"type": "query_many", "request_id": "qc", "queries": [
        {"synopsis_id": s} for s in ("src-ams", "cq1-ams", f"ams/{ids[3]}",
                                     f"narrow/{ids[4]}")]}
    for a, b in zip(je.handle(dict(q)).value, tc.handle(dict(q)).value,
                    strict=True):
        _same(a["value"], b["value"])
