"""One JSON request stream through the JAX engine (``repro.service.SDE``)
and the port's (``repro_torch.service.SDE(device="cpu")``): the same
responses -- ids and ok flags equal, CountMin values and Bloom answers
byte-equal, HyperLogLog and FM values within ``rtol=1e-6`` (float32
``exp2``/``sum``/``log`` may round differently in the last place) -- and
the same state for every entry, with the fused probe on and off. Plus
the port's guards: it imports no JAX, its engine raises without a card,
and no kind allocates without a device."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.service import SDE as JaxSDE
from repro_torch import core as tcore
from repro_torch.core import batched as tbatched
from repro_torch.kernels import ops as tops
from repro_torch.service import SDE as TorchSDE
from repro_torch.service import engine as tengine

HLL_RTOL = 1e-6      # HyperLogLog and FM estimates


def _request_stream(seed=0, n_streams=32, t=257):
    rng = np.random.RandomState(seed)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams,
                                dtype=np.int64))
    extra = int(rng.randint(0, 2**62))        # the continuous HLL's stream
    ids = [int(s) for s in pop]
    cm = {"eps": 0.05, "delta": 0.05}
    hll = {"rse": 0.1}
    bloom = {"n_elements": 64, "fpr": 0.05}
    fm = {"nmaps": 8, "bitmap_size": 16}
    reqs = [
        {"type": "build", "request_id": "b-cm", "synopsis_id": "cm",
         "kind": "countmin", "params": cm, "per_stream_of_source": True,
         "stream_ids": ids, "source_id": "src"},
        {"type": "build", "request_id": "b-hll", "synopsis_id": "hll",
         "kind": "hyperloglog", "params": hll,
         "per_stream_of_source": True, "stream_ids": ids},
        {"type": "build", "request_id": "b-src-cm", "synopsis_id": "src-cm",
         "kind": "countmin", "params": cm},
        {"type": "build", "request_id": "b-src-hll",
         "synopsis_id": "src-hll", "kind": "hyperloglog", "params": hll},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-hll",
         "kind": "hyperloglog", "params": hll, "stream_id": extra,
         "continuous": True},
        {"type": "build", "request_id": "b-bad", "synopsis_id": "x",
         "kind": "no_such_kind"},
        {"type": "build", "request_id": "b-bloom", "synopsis_id": "bloom",
         "kind": "bloom", "params": bloom, "per_stream_of_source": True,
         "stream_ids": ids},
        {"type": "build", "request_id": "b-fm", "synopsis_id": "fm",
         "kind": "fm", "params": fm, "per_stream_of_source": True,
         "stream_ids": ids},
        {"type": "build", "request_id": "b-src-bloom",
         "synopsis_id": "src-bloom", "kind": "bloom", "params": bloom},
        {"type": "build", "request_id": "b-src-fm", "synopsis_id": "src-fm",
         "kind": "fm", "params": fm},
        {"type": "build", "request_id": "b-cq-fm", "synopsis_id": "cq-fm",
         "kind": "fm", "params": fm, "stream_id": extra,
         "continuous": True},
        {"type": "build", "request_id": "b-fm-bad", "synopsis_id": "fm3",
         "kind": "fm", "params": {"nmaps": 3}},         # not a power of 2
    ]
    for b in range(3):
        sids = pop[rng.randint(0, len(pop), t)].copy()
        sids[::9] = extra
        sids[::11] = int(rng.randint(0, 2**62)) | 1   # unrouted
        sids[::17] = -3                               # negative: masked
        reqs.append({"type": "ingest", "request_id": f"i{b}",
                     "stream_ids": [int(s) for s in sids],
                     "values": rng.randint(1, 5, t).tolist()})
    reqs += [
        {"type": "adhoc", "request_id": "q-cm", "synopsis_id": f"cm/{ids[2]}",
         "query": {"items": [ids[2], ids[3], 7]}},
        {"type": "adhoc", "request_id": "q-src-cm", "synopsis_id": "src-cm",
         "query": {"items": ids[:5]}},
        {"type": "adhoc", "request_id": "q-hll",
         "synopsis_id": f"hll/{ids[1]}"},
        {"type": "adhoc", "request_id": "q-src-hll",
         "synopsis_id": "src-hll"},
        {"type": "query_many", "request_id": "qm", "queries": [
            {"synopsis_id": f"cm/{ids[0]}", "query": {"items": [ids[0]]}},
            17,                                           # malformed
            {"synopsis_id": "src-hll"},
            {"synopsis_id": "nope"},
            {"synopsis_id": "src-cm", "query": {"items": [-1]}}]},
        {"type": "query_many", "request_id": "qm-bloom", "queries": [
            {"synopsis_id": f"bloom/{ids[0]}",
             "query": {"items": [ids[0], ids[1], 5]}},
            {"synopsis_id": "src-bloom", "query": {"items": ids + [3, 4]}},
            {"synopsis_id": "src-bloom", "query": {"items": "nope"}},
            {"synopsis_id": f"bloom/{ids[3]}", "query": {"items": [ids[3]]}},
            {"synopsis_id": "src-fm"}]},
        {"type": "adhoc", "request_id": "q-fm",
         "synopsis_id": f"fm/{ids[1]}"},
        {"type": "adhoc", "request_id": "q-src-fm", "synopsis_id": "src-fm"},
        {"type": "adhoc", "request_id": "q-bloom",
         "synopsis_id": f"bloom/{ids[2]}", "query": {"items": [ids[2]]}},
        {"type": "status", "request_id": "st"},
        {"type": "stop", "request_id": "s-cm", "synopsis_id": "cm"},
        {"type": "stop", "request_id": "s-bloom", "synopsis_id": "bloom"},
        {"type": "build", "request_id": "b-bloom2", "synopsis_id": "bloom",
         "kind": "bloom", "params": bloom, "per_stream_of_source": True,
         "stream_ids": ids},
        {"type": "adhoc", "request_id": "q-bloom2",
         "synopsis_id": f"bloom/{ids[2]}", "query": {"items": [ids[2]]}},
        {"type": "build", "request_id": "b-cm2", "synopsis_id": "cm",
         "kind": "countmin", "params": cm, "per_stream_of_source": True,
         "stream_ids": ids},
        {"type": "adhoc", "request_id": "q-cm2",
         "synopsis_id": f"cm/{ids[2]}", "query": {"items": [ids[2]]}},
        {"type": "flush", "request_id": "fl"},
    ]
    return reqs, ids


def _same_value(a, b, rtol):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_value(a[k], b[k], rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y, rtol)
    elif isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if rtol:
            np.testing.assert_allclose(b, a, rtol=rtol)
        else:
            assert np.array_equal(a, b)
    else:
        assert a == b


def _rtol(synopsis_id):
    """HLL and FM answers to HLL_RTOL, CountMin and Bloom byte for byte."""
    sid = str(synopsis_id)
    return HLL_RTOL if "hll" in sid or "fm" in sid else 0


def _same_response(ra, rb):
    assert (ra.request_id, ra.synopsis_id, ra.ok) == \
        (rb.request_id, rb.synopsis_id, rb.ok), (ra, rb)
    if isinstance(ra.value, list):              # query_many: per entry
        assert len(ra.value) == len(rb.value)
        for a, b in zip(ra.value, rb.value):
            assert (a["request_id"], a["ok"]) == (b["request_id"], b["ok"])
            _same_value(a["value"], b["value"], _rtol(a["synopsis_id"]))
    elif ra.ok:
        _same_value(ra.value, rb.value, _rtol(ra.synopsis_id))
        # status: the reference's keys and Python types; ``device`` is the
        # port's one extra key
        got = {k: v for k, v in rb.params.items()
               if not (ra.request_id == "st" and k == "device")}
        assert ra.params == got
        assert {k: type(v) for k, v in ra.params.items()} == \
            {k: type(v) for k, v in got.items()}


# Bloom answers and CountMin values: the JSON a client reads is the same
_SAME_JSON = ("q-cm", "q-src-cm", "q-bloom", "q-bloom2", "b-fm-bad")


# The reference's status counters are process-wide and keyed by site;
# other test files in the same worker move them for the default site, so
# both engines here get a site of their own.
SITE = "torch-parity"


def _drive(monkeypatch, fused):
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    reqs, ids = _request_stream()
    je, te = JaxSDE(site=SITE), TorchSDE(site=SITE, device="cpu")
    before = dict(tops.DISPATCH_COUNT)
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        _same_response(ra, rb)
        if r["request_id"] in _SAME_JSON:
            assert ra.to_json() == rb.to_json(), r["request_id"]
    return je, te, reqs, ids, before


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_request_stream_matches_jax_engine(monkeypatch, fused):
    je, te, reqs, ids, before = _drive(monkeypatch, fused)
    # every entry holds the same state
    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        want = np.asarray(je.state_of(sid))
        got = te.state_of(sid).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), sid
    # continuous responses: same ids, HLL and FM values to rtol
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    assert sorted(r.request_id for r in te.continuous_out) == sorted(
        f"cq/{sid}/{b}" for sid in ("cq-hll", "cq-fm") for b in (1, 2, 3))
    for ra, rb in zip(je.continuous_out, te.continuous_out):
        _same_value(ra.value, rb.value, HLL_RTOL)
    # one update per kind stack per ingest batch
    n_ingest = sum(r["type"] == "ingest" for r in reqs)
    for name in ("CountMin", "HyperLogLog", "BloomFilter", "FMSketch"):
        key = f"update:{name}"
        assert tops.DISPATCH_COUNT[key] - before.get(key, 0) == n_ingest
    assert te.memory_bytes() == sum(
        s.state.nbytes for s in je.stacks.values())


def test_rebuilt_synopsis_reads_zero_and_later_slices_answer_not_ok(
        monkeypatch):
    _, te, _, ids, _ = _drive(monkeypatch, True)
    r = te.handle({"type": "adhoc", "request_id": "q",
                   "synopsis_id": f"cm/{ids[2]}", "query": {"items": [ids[2]]}})
    assert r.ok and float(r.value[0]) == 0.0
    r = te.handle({"type": "build", "request_id": "b", "synopsis_id": "x",
                   "kind": "coreset_tree"})
    assert not r.ok and "unknown synopsis kind" in r.error
    for req, slice_name in (
            ({"type": "build_multidim", "request_id": "md",
              "synopsis_id": "m", "dims": {"a": [1, 2]}}, "multidim"),
            ({"type": "subpop_query", "request_id": "sp",
              "synopsis_id": "m"}, "subpop"),
            ({"type": "federated_query", "request_id": "fq",
              "synopsis_id": "m"}, "federation")):
        r = te.handle(req)
        assert not r.ok and slice_name in r.error and \
            r.request_id == req["request_id"]
    r = te.handle('{"type": "nonsense", "request_id": "z"}')
    assert not r.ok
    r = te.handle({"type": "shutdown", "request_id": "sd"})
    assert r.ok and r.value["synopses"] == 4 * len(ids) + 6
    assert te.stacks == {} and te.entries == {}


def test_sde_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TorchSDE()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TorchSDE(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        TorchSDE(device="meta")
    assert TorchSDE(device="cpu").device.type == "cpu"


def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch.service, repro_torch.convert, "
            "repro_torch.kernels.ops\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.smoke
def test_plan_queries_pads_and_reports_bad_items():
    from repro_torch import core
    args, take, errors = tengine._plan_queries(
        core.CountMin(), [{"items": [1, 2, 3]}, {"items": "x"}, {}],
        torch.device("cpu"))
    assert args[0].shape == (3, 4)
    assert errors[0] is None and errors[2] is None
    assert "bad 'items'" in errors[1]
    out = np.arange(12).reshape(3, 4)
    assert take(out, 0).tolist() == [0, 1, 2]


@pytest.mark.parametrize("name", ["countmin", "ams", "hyperloglog", "bloom",
                                  "fm"])
def test_init_and_stacked_init_need_a_device(name):
    kind = tcore.make_kind(name)
    with pytest.raises(TypeError):
        kind.init()
    with pytest.raises(TypeError):
        tbatched.stacked_init(kind, 4)
    assert tbatched.stacked_init(kind, 4, "cpu").device.type == "cpu"


def test_bloom_answers_membership_without_false_negatives(monkeypatch):
    _, te, reqs, ids, _ = _drive(monkeypatch, True)
    r = te.handle({"type": "query_many", "request_id": "m", "queries": [
        {"synopsis_id": "src-bloom", "query": {"items": ids}},
        {"synopsis_id": f"bloom/{ids[5]}", "query": {"items": [ids[5]]}}]})
    ingested = {s for q in reqs if q["type"] == "ingest"
                for s in q["stream_ids"] if s >= 0}
    src, own = (v["value"] for v in r.value)
    assert src.dtype == bool and own.dtype == bool
    assert all(bool(v) for i, v in zip(ids, src) if i in ingested)
    assert own.tolist() == [False]           # stopped, rebuilt, not fed
