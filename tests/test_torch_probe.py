"""The port's route table and probe against the JAX package's: identical
table contents after the same insert/remove sequence, and identical probe
rows on hits, misses and lanes displaced beyond ``n_probe``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import probe as jprobe
from repro.service import routing as jrouting
from repro_torch.kernels import probe as tprobe
from repro_torch.service import routing as trouting


def _sequence(table_cls, rng_seed=0):
    rng = np.random.RandomState(rng_seed)
    t = table_cls()
    ids = rng.randint(0, 2**63 - 1, size=600, dtype=np.int64)
    t.insert_many(ids[:300], np.arange(300, dtype=np.int32))
    t.insert_many(ids[200:450], np.arange(200, 450, dtype=np.int32) + 1000)
    t.remove_rows(np.arange(0, 120, dtype=np.int32))
    t.insert_many(ids[450:], np.arange(450, 600, dtype=np.int32))
    t.remove_rows(np.asarray([1300, 1301, 555], np.int32))
    return t, ids


def test_tables_identical_after_same_sequence():
    a, _ = _sequence(jrouting.RouteTable)
    b, _ = _sequence(trouting.RouteTable)
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.rows, b.rows)
    assert (a.count, a.max_probe, a.size) == (b.count, b.max_probe, b.size)


def _mirrors(table):
    lo, hi = jrouting.split64(table.keys)
    j = (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(table.rows))
    t = (torch.from_numpy(lo.view(np.int32).copy()),
         torch.from_numpy(hi.view(np.int32).copy()),
         torch.from_numpy(table.rows.copy()))
    return j, t


def _probe_both(table, sids, n_probe):
    (jlo, jhi, jrows), (tlo, thi, trows) = _mirrors(table)
    slo, shi = jrouting.split64(sids)
    want = np.asarray(jprobe.probe_rows(jlo, jhi, jrows, jnp.asarray(slo),
                                        jnp.asarray(shi), n_probe=n_probe))
    got = tprobe.probe_rows(tlo, thi, trows,
                            torch.from_numpy(slo.view(np.int32).copy()),
                            torch.from_numpy(shi.view(np.int32).copy()),
                            n_probe=n_probe)
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.smoke
def test_probe_rows_hits_and_misses():
    table, ids = _sequence(trouting.RouteTable)
    rng = np.random.RandomState(1)
    misses = rng.randint(0, 2**63 - 1, size=200, dtype=np.int64)
    sids = np.concatenate([ids, misses, [-1, -5, 0, 2**63 - 1]]).astype(
        np.int64)
    n_probe = trouting.next_pow2(table.max_probe)
    want, got = _probe_both(table, sids, n_probe)
    assert np.array_equal(want, got)
    assert np.array_equal(got, table.lookup_many(sids))   # host twin
    assert (got >= 0).sum() > 300 and (got == -1).sum() > 200


def test_probe_rows_beyond_n_probe_resolve_to_minus_one():
    """A dense cluster of keys so some sit several slots from home; a
    short probe bound must give -1 for exactly those, as in JAX."""
    table = trouting.RouteTable(64)
    # ids whose start slot is the same in a 64-slot table
    cand = np.arange(1, 200000, dtype=np.int64)
    slots = trouting.slot_hash(*trouting.split64(cand), 64)
    same = cand[slots == slots[0]][:6]
    table.insert_many(same, np.arange(6, dtype=np.int32))
    assert table.size == 64 and table.max_probe >= 6
    for n_probe in (1, 2, 3, 8):
        want, got = _probe_both(table, same, n_probe)
        assert np.array_equal(want, got), n_probe
        assert (got == -1).sum() == max(0, 6 - n_probe)
