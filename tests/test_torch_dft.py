"""DFT (StatStream) in the port against the JAX package: the kind
(``core/dft.py``), the stack tick (``batched.stacked_step``), the plain
sliding-DFT tick against the reference's oracle and its Pallas kernel in
interpret mode (``ops.dft_step``), the engine's time-series path through
``SDE.handle``, the reference's time-series semantics one by one, and a
converted engine.

Tolerances: ``pos``, ``count``, ``ring``, ``coords`` and ``bucket`` must be
byte-equal. The float leaves (``total``, ``totsq``, ``coeff``) and the
normalized coefficients are held to ``rtol=1e-5, atol=1e-5``. Where the
reference runs op by op (``DFT.step``, the vmapped ``stacked_step``, the
oracle ``ref.sliding_dft_step``) they are byte-equal as well, and the
tests say so. Where it runs jit-compiled (the engine's ``_step_fn``,
``add_batch``'s scan, the Pallas kernel in interpret mode), XLA on the
CPU contracts ``a*b - c*d`` and ``t + x*x - y*y`` into fused
multiply-adds, which round once where the port (and the oracle) round
twice: a last-place difference per tick, which the recursion carries on.
The port's kernel does not contract (``csrc/sliding_dft.cu``)."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.service import SDE as JaxSDE
from test_torch_convert import jax_contents
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref, sliding_dft
from repro_torch.service import SDE as TorchSDE

RTOL, ATOL = 1e-5, 1e-5
EXACT = ("pos", "count", "ring")
LEAVES = ("coeff", "count", "pos", "ring", "total", "totsq")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bytes(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


def _check_state(got, want, same_bytes=False):
    """Six leaves: exact ones byte-equal, float ones to RTOL/ATOL (and
    byte-equal when ``same_bytes``)."""
    assert sorted(got) == sorted(want) == list(LEAVES)
    for k in LEAVES:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in EXACT or same_bytes:
            assert _same_bytes(g, w), k
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def _same_json(got: str, want: str):
    """Two responses' JSON texts: the same keys in the same order and the
    same values, floats to RTOL/ATOL (the coefficients)."""
    def same(a, b):
        assert type(a) is type(b), (a, b)
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, float):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        else:
            assert a == b
    same(json.loads(got), json.loads(want))


def _check_answer(got, want, same_bytes=False):
    assert sorted(got) == sorted(want) == ["bucket", "coeffs", "coords"]
    for k in ("bucket", "coords"):
        assert _same_bytes(np.asarray(got[k]), np.asarray(want[k])), k
    g, w = np.asarray(got["coeffs"]), np.asarray(want["coeffs"])
    if same_bytes:
        assert _same_bytes(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


KINDS = [dict(window=16, n_coeffs=4),
         dict(window=24, n_coeffs=5, threshold=0.85, grid_coeffs=3),
         dict(window=128, n_coeffs=8, threshold=0.9, grid_coeffs=2)]
KIND_IDS = ["w16", "w24", "fig6"]


@pytest.mark.smoke
@pytest.mark.parametrize("params", KINDS[:2], ids=KIND_IDS[:2])
def test_kind_step_matches_jax(params):
    """One row, ticked 2 W times (the ring wraps) with some invalid
    ticks, through ``DFT.step`` in both packages; then the estimate, the
    twiddles, the merge and the footprint."""
    jk, tk = jcore.DFT(**params), tcore.DFT(**params)
    rng = np.random.RandomState(params["window"])
    js, ts = jk.init(), tk.init("cpu")
    for i in range(2 * jk.window):
        x = np.float32(rng.randn() * 4)
        ok = bool(rng.rand() > 0.2)
        js = jk.step(js, x, ok)
        assert tk.step(ts, x, ok) is ts                 # in place
    _check_state(ts, js, same_bytes=True)
    assert int(ts["count"]) > jk.window
    _check_answer(tk.estimate(ts), jk.estimate(js), same_bytes=True)
    assert _same_bytes(tk._twiddle("cpu").T.contiguous().numpy(),
                       np.asarray(jk._twiddle()))
    assert (tk.eps, tk.grid_cells, tk.merge_mode, tk.memory_bytes()) == \
        (jk.eps, jk.grid_cells, jk.merge_mode, jk.memory_bytes())
    fresh, fresh_t = jk.init(), tk.init("cpu")
    for a, b, ja, jb in ((ts, fresh_t, js, fresh), (fresh_t, ts, fresh, js)):
        _check_state(tk.merge(a, b), jk.merge(ja, jb), same_bytes=True)
    # add_batch is a run of ticks of one stream (items unused); the
    # reference's is a compiled scan
    vals = (rng.randn(30) * 3).astype(np.float32)
    mask = rng.rand(30) > 0.1
    jb = jk.add_batch(jk.init(), jnp.zeros(30, jnp.uint32), jnp.asarray(vals),
                      jnp.asarray(mask))
    tb = tk.add_batch(tk.init("cpu"), None, _t(vals), _t(mask))
    _check_state(tb, jb)


def test_init_needs_a_device_and_has_six_leaves():
    kind = tcore.make_kind("dft", window=8, n_coeffs=3)
    with pytest.raises(TypeError):
        kind.init()
    with pytest.raises(TypeError):
        tbatched.stacked_init(kind, 4)
    st = tbatched.stacked_init(kind, 4, "cpu")
    want = jbatched.stacked_init(jcore.DFT(window=8, n_coeffs=3), 4)
    _check_state(st, want, same_bytes=True)


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("params", KINDS, ids=KIND_IDS)
def test_stacked_step_matches_jax(params, s):
    """Every row of a stack ticked 2 W + 5 times, rows masked at random:
    the port's stack tick (window leaves in torch, coefficients through
    ``ops.dft_step``) against the reference's vmap of ``DFT.step``, and
    the stacked estimates of every row."""
    jk, tk = jcore.DFT(**params), tcore.DFT(**params)
    rng = np.random.RandomState(s + jk.window)
    js = jbatched.stacked_init(jk, s)
    ts = tbatched.stacked_init(tk, s, "cpu")
    for _ in range(2 * jk.window + 5):
        v = (rng.randn(s) * 5).astype(np.float32)
        m = rng.rand(s) > 0.3
        js = jbatched.stacked_step(jk, js, jnp.asarray(v), jnp.asarray(m))
        assert tbatched.stacked_step(tk, ts, _t(v), _t(m)) is ts
    _check_state(ts, js, same_bytes=True)
    rows = np.arange(s, dtype=np.int32)[::-1].copy()
    jest = jbatched.stacked_estimate(jk, js, jnp.asarray(rows))
    test = tbatched.stacked_estimate(tk, ts, _t(rows))
    _check_answer({k: v.numpy() for k, v in test.items()}, jest,
                  same_bytes=True)
    # the kind's plain stack tick gives the same bytes as the kernel path
    plain = tbatched.stacked_init(tk, s, "cpu")
    again = tbatched.stacked_init(tk, s, "cpu")
    for _ in range(jk.window + 3):
        v = _t((rng.randn(s) * 5).astype(np.float32))
        m = _t(rng.rand(s) > 0.3)
        tk.step(plain, v, m)
        tbatched.stacked_step(tk, again, v, m)
    for k in LEAVES:
        assert _same_bytes(plain[k].numpy(), again[k].numpy()), k


@pytest.mark.parametrize("mask_kind", ["random", "all", "none"])
@pytest.mark.parametrize("s,f", [(1, 1), (37, 1), (513, 8), (1000, 16),
                                 (129, 3)])
def test_plain_sliding_dft_step_matches_jax_oracle_and_pallas(s, f,
                                                              mask_kind):
    """``ref.sliding_dft_step`` against ``repro/kernels/ref.py`` (byte for
    byte) and the Pallas kernel in interpret mode (``ops.dft_step``, which
    pads odd S; to RTOL/ATOL, its products contracted); the port ticks in
    place, on contiguous planes and on the interleaved [S, F, 2] views."""
    rng = np.random.RandomState(s * 7 + f)
    re = (rng.randn(s, f) * 3).astype(np.float32)
    im = (rng.randn(s, f) * 3).astype(np.float32)
    delta = (rng.randn(s) * 2).astype(np.float32)
    mask = {"random": (rng.rand(s) > 0.4), "all": np.ones(s, bool),
            "none": np.zeros(s, bool)}[mask_kind].astype(np.float32)
    ang = 2 * np.pi * np.arange(1, f + 1) / 64.0
    twr, twi = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    args = (re, im, delta, mask, twr, twi)
    want = jref.sliding_dft_step(*map(jnp.asarray, args))
    pallas = jops.dft_step(*map(jnp.asarray, args))
    planes = (_t(re.copy()), _t(im.copy()))
    got = ref.sliding_dft_step(*planes, *map(_t, args[2:]))
    assert got[0] is planes[0] and got[1] is planes[1]    # in place
    for g, w, p in zip(got, want, pallas):
        assert _same_bytes(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=RTOL,
                                   atol=ATOL)
    coeff = _t(np.stack([re, im], -1))
    out = tops.dft_step(coeff[..., 0], coeff[..., 1], _t(delta),
                        _t(mask > 0), _t(twr), _t(twi))
    assert out[0].data_ptr() == coeff.data_ptr()          # in place
    for g, w in zip(out, want):
        assert _same_bytes(g.contiguous().numpy(), np.asarray(w))
    assert sliding_dft.sliding_dft_step.launches == 0     # no card here


def test_dft_step_wrapper_launches_only_on_the_card():
    re = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sliding_dft.sliding_dft_step(re, re, re[:, 0], re[:, 0], re[0],
                                     re[0])


# ---------------------------------------------------------------------------
# the engine's time-series path, JSON in and out
# ---------------------------------------------------------------------------
def _engines(reqs):
    je, te = JaxSDE(), TorchSDE(device="cpu")
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        assert (ra.request_id, ra.synopsis_id, ra.ok) == \
            (rb.request_id, rb.synopsis_id, rb.ok), (ra, rb)
    return je, te


def _ingest(rid, sids, vals, mask=None):
    r = {"type": "ingest", "request_id": rid,
         "stream_ids": [int(s) for s in sids],
         "values": [float(v) for v in vals]}
    if mask is not None:
        r["mask"] = [bool(m) for m in mask]
    return r


def _dft_requests(rng, ids, extra, n_batches, t=97, first=0):
    reqs = []
    pop = np.asarray(ids, np.int64)
    for b in range(first, first + n_batches):
        sids = pop[rng.randint(0, len(pop), t)].copy()
        sids[::9] = extra
        sids[::11] = int(rng.randint(0, 2**62)) | 1   # unrouted
        sids[::17] = -3                               # negative: masked
        vals = (rng.randn(t) * 3).astype(np.float32)
        reqs.append(_ingest(f"i{b}", sids, vals, rng.rand(t) > 0.1))
    return reqs


def _same_value(a, b):
    if isinstance(a, dict):
        _check_answer(b, a)
    else:
        assert a == b


def test_engine_json_flow_matches_jax_engine():
    """Per-stream, data-source and continuous DFT through ``SDE.handle``
    with W + 8 ingests (every ring wraps): the same responses (JSON text
    included), the same state for every entry, the same continuous
    emissions; then stop and rebuild (reads init), and status."""
    rng = np.random.RandomState(9)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=24,
                                                 dtype=np.int64))]
    extra = int(rng.randint(0, 2**62))
    w = 16
    reqs = [
        {"type": "build", "request_id": "b-dft", "synopsis_id": "dft",
         "kind": "dft", "params": {"window": w, "n_coeffs": 4},
         "per_stream_of_source": True, "stream_ids": ids},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-dft",
         "kind": "dft", "params": {"window": w, "n_coeffs": 4}},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-dft",
         "kind": "dft", "params": {"window": w, "n_coeffs": 4},
         "stream_id": extra, "continuous": True},
        {"type": "build", "request_id": "b-fig6", "synopsis_id": "fig6",
         "kind": "dft", "params": {"window": 128, "n_coeffs": 8,
                                   "threshold": 0.9, "grid_coeffs": 2},
         "per_stream_of_source": True, "stream_ids": ids[:5]},
        {"type": "build", "request_id": "b-cm", "synopsis_id": "cm",
         "kind": "countmin", "params": {"eps": 0.05, "delta": 0.1},
         "per_stream_of_source": True, "stream_ids": ids[:8]},
    ] + _dft_requests(rng, ids, extra, n_batches=w + 8)
    reqs += [
        {"type": "adhoc", "request_id": "q-dft",
         "synopsis_id": f"dft/{ids[2]}"},
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-dft"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"dft/{i}"} for i in ids[:6]] + [
            {"synopsis_id": "cq-dft"}, {"synopsis_id": f"fig6/{ids[1]}"},
            {"synopsis_id": "src-dft", "query": {"items": [1]}}, 5,
            {"synopsis_id": f"cm/{ids[3]}", "query": {"items": [ids[3]]}}]},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s", "synopsis_id": "dft"},
        {"type": "build", "request_id": "b-again", "synopsis_id": "dft",
         "kind": "dft", "params": {"window": w, "n_coeffs": 4},
         "per_stream_of_source": True, "stream_ids": ids},
        {"type": "adhoc", "request_id": "q-again",
         "synopsis_id": f"dft/{ids[2]}"},
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
                if a["ok"] and isinstance(a["value"], dict):
                    _check_answer(b["value"], a["value"])
        elif ra.ok and isinstance(ra.value, dict) and r["type"] == "adhoc":
            _check_answer(rb.value, ra.value)
        if r["type"] != "status":          # the port's status adds device
            _same_json(rb.to_json(), ra.to_json())
        else:
            assert ra.value == rb.value
            assert {k: v for k, v in rb.params.items() if k != "device"} \
                == ra.params
    again = te.handle({"type": "adhoc", "request_id": "z",
                       "synopsis_id": f"dft/{ids[2]}"}).value
    assert not again["coeffs"].any() and int(again["bucket"]) == \
        int(je.handle({"type": "adhoc", "request_id": "z",
                       "synopsis_id": f"dft/{ids[2]}"}).value["bucket"])
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        if sid.startswith("cm/"):
            assert np.array_equal(te.state_of(sid).numpy(),
                                  np.asarray(je.state_of(sid)))
        else:
            _check_state(te.state_of(sid), je.state_of(sid))
    assert int(te.state_of(f"fig6/{ids[1]}")["count"]) > 0
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    assert len(te.continuous_out) == w + 8
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same_value(ra.value, rb.value)


def test_data_source_dft_stays_at_init():
    """The reference's step path takes no source rows: a DFT built
    without a stream is never ticked. The port matches that."""
    reqs = [{"type": "build", "request_id": "b", "synopsis_id": "src",
             "kind": "dft", "params": {"window": 8, "n_coeffs": 2}},
            {"type": "build", "request_id": "c", "synopsis_id": "one",
             "kind": "dft", "params": {"window": 8, "n_coeffs": 2},
             "stream_id": 5}]
    reqs += [_ingest(f"i{b}", [5, 6, 7, 5], [1.0 + b, 2.0, 3.0, 4.0 - b])
             for b in range(10)]
    je, te = _engines(reqs)
    init = tcore.DFT(window=8, n_coeffs=2).init("cpu")
    for k in LEAVES:
        assert torch.equal(te.state_of("src")[k], init[k])
    _check_state(te.state_of("src"), je.state_of("src"))
    _check_state(te.state_of("one"), je.state_of("one"))
    assert int(te.state_of("one")["count"]) == 10


def test_last_routed_tuple_per_stream_wins():
    """Duplicate ids inside one batch: the LAST routed tuple's value ticks
    the stream -- a masked or negative later duplicate does not count --
    equivalent to a batch holding only that tuple (as
    ``tests/test_routing.py`` checks for the reference)."""
    sid = 2**45 + 17

    def build():
        return [{"type": "build", "request_id": "b", "synopsis_id": "dft",
                 "kind": "dft", "params": {"window": 16, "n_coeffs": 4},
                 "stream_id": sid},
                {"type": "build", "request_id": "c", "synopsis_id": "other",
                 "kind": "dft", "params": {"window": 16, "n_coeffs": 4},
                 "stream_id": 123}]

    dup = build() + [_ingest("d", [sid, 123, sid, 999, sid, sid],
                             [1.0, 9.0, 2.0, 7.0, 5.0, 6.0],
                             [True, True, True, True, True, False])]
    single = build() + [_ingest("s", [sid, 123], [5.0, 9.0])]
    jd, td = _engines(dup)
    js, ts = _engines(single)
    for eng in (td, ts):
        st = eng.state_of("dft")
        assert float(st["ring"][0]) == 5.0 and int(st["count"]) == 1
    for sid_ in ("dft", "other"):
        _check_state(td.state_of(sid_), jd.state_of(sid_))
        _check_state(ts.state_of(sid_), td.state_of(sid_))
        _check_state(ts.state_of(sid_), js.state_of(sid_))


def test_rows_without_a_hit_keep_all_six_leaves():
    """A row no tuple of the batch reaches keeps every leaf, ``ring``
    included, byte for byte; a hit row moves every leaf."""
    kind = tcore.DFT(window=8, n_coeffs=3)
    rng = np.random.RandomState(1)
    st = tbatched.stacked_init(kind, 5, "cpu")
    for _ in range(11):
        tbatched.stacked_step(kind, st, _t(rng.randn(5).astype(np.float32)),
                              torch.ones(5, dtype=torch.bool))
    before = {k: v.clone() for k, v in st.items()}
    hit = torch.tensor([False, True, False, False, True])
    vals = _t(rng.randn(5).astype(np.float32))
    tbatched.stacked_step(kind, st, vals, hit)
    for k in LEAVES:
        for r in (0, 2, 3):
            assert _same_bytes(st[k][r].numpy(), before[k][r].numpy()), k
        for r in (1, 4):
            assert not torch.equal(st[k][r], before[k][r]), k


def test_tick_order_and_integer_leaves_match_jax():
    """Within a tick: ``x_out = ring[pos]`` is read before the write;
    ``pos`` wraps modulo W and ``count`` stops at 2**30, both int32;
    ``total += delta`` and ``totsq = (totsq + x*x) - x_out*x_out`` in that
    order in float32 (values chosen so the other order rounds
    differently)."""
    jk, tk = jcore.DFT(window=4, n_coeffs=2), tcore.DFT(window=4, n_coeffs=2)
    js, ts = jk.init(), tk.init("cpu")
    js = dict(js, count=jnp.int32(2**30 - 1), pos=jnp.int32(3),
              ring=jnp.asarray([0.0, 0.0, 0.0, 1e4], jnp.float32),
              totsq=jnp.float32(1e8 + 3.0), total=jnp.float32(1e4))
    for k in ("count", "pos", "ring", "totsq", "total"):
        ts[k] = torch.tensor(np.asarray(js[k]))
    for x in (np.float32(1.0 + 2**-20), np.float32(3.0), np.float32(-7.5)):
        x_out = np.float32(np.asarray(js["ring"])[int(js["pos"])])
        totsq = np.float32(np.asarray(js["totsq"]))
        want_totsq = np.float32(np.float32(totsq + np.float32(x * x))
                                - np.float32(x_out * x_out))
        js = jk.step(js, x, True)
        tk.step(ts, x, True)
        _check_state(ts, js)
        assert float(ts["totsq"]) == float(want_totsq)
    assert int(ts["count"]) == 2**30 and ts["count"].dtype == torch.int32
    assert int(ts["pos"]) == 2 and ts["pos"].dtype == torch.int32
    assert float(ts["ring"][3]) == np.float32(1.0 + 2**-20)


def test_answers_floor_the_variance_and_pack_int32_buckets():
    """``coords`` and ``bucket`` are int32 and the JSON keys sorted, as the
    reference's. A constant stream has variance 0 and is floored at 1e-12
    (its normalized coefficients are the float noise of its raw ones over
    1e-6 * W, so the two packages are held to each other on one state).
    Coefficients far outside the grid, or NaN, clamp into it as the
    reference's saturating float->int32 conversion does."""
    params = {"window": 8, "n_coeffs": 3, "threshold": 0.7, "grid_coeffs": 3}
    reqs = [{"type": "build", "request_id": "b", "synopsis_id": "d",
             "kind": "dft", "params": params,
             "per_stream_of_source": True, "stream_ids": [1, 2, 3]}]
    for b in range(12):
        reqs.append(_ingest(f"i{b}", [1, 2, 3],
                            [2.5, (-1.0) ** b * 3.0, float(b % 3)]))
    reqs.append({"type": "query_many", "request_id": "qm", "queries": [
        {"synopsis_id": f"d/{s}"} for s in (2, 3)]})
    je, te = JaxSDE(), TorchSDE(device="cpu")
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        assert ra.ok and rb.ok
        _same_json(rb.to_json(), ra.to_json())
    for a, b in zip(ra.value, rb.value):
        _check_answer(b["value"], a["value"])
        assert b["value"]["bucket"].dtype == np.int32
        assert b["value"]["coords"].dtype == np.int32
        assert list(b["value"]) == ["bucket", "coeffs", "coords"]
    assert '"value": {"bucket"' in rb.to_json()
    jk, tk = jcore.DFT(**params), tcore.DFT(**params)
    const = te.state_of("d/1")
    mean = float(const["total"]) / 8
    assert float(const["totsq"]) / 8 - mean * mean <= 1e-12
    want = jk.estimate({k: jnp.asarray(v.numpy()) for k, v in const.items()})
    _check_answer({k: v.numpy() for k, v in tk.estimate(const).items()},
                  want, same_bytes=True)
    wild = np.asarray([[[3e9, -3e9], [np.nan, np.inf], [-np.inf, 0.4]],
                       [[0.1, -0.2], [0.7, -0.7], [1e-30, 5.0]]], np.float32)
    for got, want in zip(tk.bucket_of(_t(wild)), jk.bucket_of(wild)):
        assert _same_bytes(got.numpy(), np.asarray(want))


def test_converted_engine_keeps_ticking_like_the_reference():
    """A JAX engine with per-stream, data-source and continuous DFT (and a
    CountMin) after 10 batches, carried into the port (six leaves, int32
    pos/count): both keep ingesting alike past a ring wrap."""
    rng = np.random.RandomState(5)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=20,
                                                 dtype=np.int64))]
    extra = int(rng.randint(0, 2**62))
    dft = {"window": 8, "n_coeffs": 3}
    je = JaxSDE()
    for req in (
            {"type": "build", "request_id": "1", "synopsis_id": "dft",
             "kind": "dft", "params": dft, "per_stream_of_source": True,
             "stream_ids": ids},
            {"type": "build", "request_id": "2", "synopsis_id": "src",
             "kind": "dft", "params": dft},
            {"type": "build", "request_id": "3", "synopsis_id": "cq",
             "kind": "dft", "params": dft, "stream_id": extra,
             "continuous": True},
            {"type": "build", "request_id": "4", "synopsis_id": "cm",
             "kind": "countmin", "params": {"eps": 0.05, "delta": 0.1},
             "per_stream_of_source": True, "stream_ids": ids[:6]}):
        assert je.handle(req).ok
    for r in _dft_requests(rng, ids, extra, n_batches=10):
        assert je.handle(r).ok
    contents = jax_contents(je)
    te = engine_from_contents(contents, device="cpu")
    st = te.state_of(f"dft/{ids[0]}")
    assert st["pos"].dtype == st["count"].dtype == torch.int32
    for r in _dft_requests(rng, ids, extra, n_batches=6, first=10):
        assert je.handle(dict(r)).ok and te.handle(dict(r)).ok
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        got, want = te.state_of(sid), je.state_of(sid)
        if isinstance(want, dict):
            _check_state(got, want)
        else:
            assert np.array_equal(got.numpy(), np.asarray(want))
    assert [r.request_id for r in je.continuous_out][-6:] == \
        [r.request_id for r in te.continuous_out]
    for ra, rb in zip(list(je.continuous_out)[-6:], te.continuous_out):
        _same_value(ra.value, rb.value)
    assert jax.tree.leaves(je.state_of("src"))[0].shape == (3, 2)
