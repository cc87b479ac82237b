"""Carry a JAX engine's contents into the port (``repro_torch.convert``)
after 2 batches, ingest 2 more into both, and hold the states equal:
CountMin, HyperLogLog, Bloom and FM stacks, per-stream, data-source and
continuous entries."""
import numpy as np
import pytest

from repro.core.synopsis import kind_params, name_of_kind
from repro.service import SDE as JaxSDE
from repro_torch.convert import engine_from_contents


def jax_contents(eng) -> dict:
    """The plain-numpy contents ``engine_from_contents`` takes."""
    kinds = list(eng.stacks)
    return dict(
        site=eng.site, tuples_ingested=eng.tuples_ingested,
        batches_ingested=eng.batches_ingested,
        stacks=[dict(kind=name_of_kind(k), params=kind_params(k),
                     state=({k: np.asarray(v) for k, v in s.state.items()}
                            if isinstance(s.state, dict)
                            else np.asarray(s.state)),
                     table_keys=s.table.keys.copy(),
                     table_rows=s.table.rows.copy(),
                     table_max_probe=s.table.max_probe,
                     source_rows=list(s.source_rows))
                for k, s in eng.stacks.items()],
        entries=[dict(synopsis_id=sid, stack=kinds.index(e.kind_key),
                      row=e.row, stream_id=e.stream_id,
                      continuous=e.continuous)
                 for sid, e in eng.entries.items()])


@pytest.mark.smoke
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_converted_engine_keeps_ingesting_like_the_reference(monkeypatch,
                                                             fused):
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    rng = np.random.RandomState(5)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=40, dtype=np.int64))
    ids = [int(s) for s in pop]
    je = JaxSDE()
    for req in (
            {"type": "build", "request_id": "1", "synopsis_id": "cm",
             "kind": "countmin", "params": {"eps": 0.05, "delta": 0.1},
             "per_stream_of_source": True, "stream_ids": ids},
            {"type": "build", "request_id": "2", "synopsis_id": "hll",
             "kind": "hyperloglog", "params": {"rse": 0.1},
             "per_stream_of_source": True, "stream_ids": ids[:20]},
            {"type": "build", "request_id": "3", "synopsis_id": "src",
             "kind": "countmin", "params": {"eps": 0.05, "delta": 0.1}},
            {"type": "build", "request_id": "4", "synopsis_id": "cq",
             "kind": "hyperloglog", "params": {"rse": 0.1},
             "continuous": True},
            {"type": "build", "request_id": "5", "synopsis_id": "bloom",
             "kind": "bloom", "params": {"n_elements": 64, "fpr": 0.05},
             "per_stream_of_source": True, "stream_ids": ids[10:]},
            {"type": "build", "request_id": "6", "synopsis_id": "src-bloom",
             "kind": "bloom", "params": {"n_elements": 64, "fpr": 0.05}},
            {"type": "build", "request_id": "7", "synopsis_id": "fm",
             "kind": "fm", "params": {"nmaps": 8, "bitmap_size": 16},
             "per_stream_of_source": True, "stream_ids": ids[:30]},
            {"type": "build", "request_id": "8", "synopsis_id": "cq-fm",
             "kind": "fm", "params": {"nmaps": 8, "bitmap_size": 16},
             "continuous": True}):
        assert je.handle(req).ok
    batches = []
    for _ in range(4):
        sids = pop[rng.randint(0, len(pop), 300)]
        sids[::7] = int(rng.randint(0, 2**62)) | 3     # unrouted
        batches.append((sids, rng.randint(1, 6, 300).astype(np.float32)))
    for sids, vals in batches[:2]:
        je.ingest(sids, vals)

    te = engine_from_contents(jax_contents(je), device="cpu")
    assert te.tuples_ingested == je.tuples_ingested
    for sids, vals in batches[2:]:
        assert je.ingest(sids, vals) == te.ingest(sids, vals)

    assert set(je.entries) == set(te.entries)
    for sid in je.entries:
        assert np.array_equal(np.asarray(je.state_of(sid)),
                              te.state_of(sid).numpy()), sid
    # two continuous queries x the 2 batches ingested after the carry
    assert [r.request_id for r in je.continuous_out][-4:] == \
        [r.request_id for r in te.continuous_out]
    r = te.handle({"type": "adhoc", "request_id": "q",
                   "synopsis_id": f"cm/{ids[4]}",
                   "query": {"items": [ids[4]]}})
    want = je.handle({"type": "adhoc", "request_id": "q",
                      "synopsis_id": f"cm/{ids[4]}",
                      "query": {"items": [ids[4]]}})
    assert r.ok and np.array_equal(r.value, want.value)
    q = {"type": "adhoc", "request_id": "b", "synopsis_id": "src-bloom",
         "query": {"items": ids + [1, 2]}}
    r, want = te.handle(dict(q)), je.handle(dict(q))
    assert r.ok and list(r.value) == list(want.value)
