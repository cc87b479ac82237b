"""The port's registry update functions and plain kernel versions against
the JAX package's: the Pallas kernels in interpret mode
(``repro.kernels.ops.resolve_update_kernel``), ``batched.stacked_update``
and the pure-jnp oracles of ``repro/kernels/ref.py``, at the sizes of
``tests/test_kernel_registry.py``.

Integer weights, and every Bloom and FM state, must agree byte for byte.
Float CountMin and AMS weights agree to ``rtol=1e-6, atol=1e-5``: the
reference's one-hot matmul and the port's sequential scatter add the same
terms in another order.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.kernels import bitset_or as jbitset_or
from repro.kernels import fm_bitmap as jfm_bitmap
from repro.kernels import hll_max as jhll_max
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.service import routing as jrouting
from repro_torch import core as tcore
from repro_torch.core import batched as tbatched
from repro_torch.kernels import (bitset_or, fm_bitmap, hll_max, onehot_matmul,
                                 ops as tops, ref)

_KINDS = {
    "cm_unweighted": ({"eps": 0.1, "delta": 0.1, "weighted": False},
                      "countmin"),
    "cm_weighted": ({"eps": 0.05, "delta": 0.05}, "countmin"),
    "ams": ({"eps": 0.1, "delta": 0.2}, "ams"),           # d = 7, w = 512
    "ams_default": ({}, "ams"),                           # d = 12, w = 2048
    "hll": ({"rse": 0.1}, "hyperloglog"),
    "bloom": ({"n_elements": 64, "fpr": 0.05}, "bloom"),
    "fm": ({"nmaps": 8, "bitmap_size": 16}, "fm"),
    "fm_one_map": ({"nmaps": 1}, "fm"),      # which = h >> 32
}
_MAX_KINDS = ("hyperloglog", "bloom", "fm")  # exact whatever the weights


def _inputs(seed, n=24, t=300, float_weights=False, zipf=None):
    """Routed ids over n streams, uniform or (``zipf``) Zipf-distributed
    over the rows, every 13th unrouted."""
    rng = np.random.RandomState(seed)
    pop = np.unique(rng.randint(0, 2**62, size=4 * n, dtype=np.int64))[:n]
    table = jrouting.RouteTable()
    table.insert_many(pop, np.arange(n, dtype=np.int32))
    if zipf is None:
        sids = pop[rng.randint(0, n, t)]
    else:
        p = 1.0 / np.arange(1, n + 1) ** zipf
        sids = pop[rng.choice(n, t, p=p / p.sum())]
    sids[::13] = int(pop.max()) + 7          # unrouted: must be dropped
    vals = (rng.rand(t) * 4 if float_weights
            else rng.randint(1, 4, t)).astype(np.float32)
    return dict(table=table, sids=sids, vals=vals, msk=rng.rand(t) > 0.2,
                src=np.asarray([1, 5], np.int32), n=n,
                n_probe=jrouting.next_pow2(table.max_probe))


def _jax_args(x):
    klo, khi = (jnp.asarray(h) for h in jrouting.split64(x["table"].keys))
    slo, shi = (jnp.asarray(h) for h in jrouting.split64(x["sids"]))
    return (klo, khi, jnp.asarray(x["table"].rows), slo, shi,
            jnp.asarray(jrouting.fold64(x["sids"])), jnp.asarray(x["vals"]),
            jnp.asarray(x["msk"]), jnp.asarray(x["src"]))


def _torch_args(x):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    klo, khi = (t(h.view(np.int32)) for h in jrouting.split64(
        x["table"].keys))
    slo, shi = (t(h.view(np.int32)) for h in jrouting.split64(x["sids"]))
    return (klo, khi, t(x["table"].rows), slo, shi,
            t(jrouting.fold64(x["sids"]).view(np.int32)), t(x["vals"]),
            t(x["msk"]), t(x["src"]).long())


def _check(got, want, exact):
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("name", sorted(_KINDS))
def test_update_fn_matches_pallas_and_stacked_update(name, float_weights,
                                                     fuse):
    _check_update_fn(name, _inputs(3, float_weights=float_weights),
                     float_weights, fuse)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("name", ["cm_unweighted", "cm_weighted"])
def test_cm_zipf_hot_batch_matches_pallas_and_stacked_update(
        name, float_weights, fuse):
    """The batch shape the card's row sort and walk are built for: Zipf(1.1)
    over 24 streams, so the hottest row takes 256+ tuples (a run the walk
    carries across many 32-position steps), with unrouted ids (rows -1)."""
    x = _inputs(5, t=1500, float_weights=float_weights, zipf=1.1)
    rows = np.asarray(jops.route_probe(*_jax_args(x)[:5],
                                       n_probe=x["n_probe"]))
    assert np.bincount(rows[rows >= 0]).max() >= 256
    assert (rows == -1).any()
    _check_update_fn(name, x, float_weights, fuse)


def _check_update_fn(name, x, float_weights, fuse):
    params, registry_name = _KINDS[name]
    jkind = jcore.make_kind(registry_name, **params)
    tkind = tcore.make_kind(registry_name, **params)
    ja = _jax_args(x)
    state0 = np.asarray(jbatched.stacked_init(jkind, x["n"]))

    pallas = np.asarray(jops.resolve_update_kernel(jkind, fuse)(
        jnp.asarray(state0), *ja, n_probe=x["n_probe"]))
    rows = jops.route_probe(*ja[:5], n_probe=x["n_probe"])
    xla = np.asarray(jbatched.stacked_update(jkind, jnp.asarray(state0),
                                             rows, *ja[5:]))

    ta = _torch_args(x)
    state = torch.from_numpy(state0.copy())
    out = tops.resolve_update_kernel(tkind, fuse)(state, *ta,
                                                  n_probe=x["n_probe"])
    assert out.data_ptr() == state.data_ptr()          # updated in place
    exact = registry_name in _MAX_KINDS or not float_weights
    _check(out.numpy(), pallas, exact)
    _check(out.numpy(), xla, exact)

    # the port's own plain oracle path agrees too
    trows = tops.route_probe(*ta[:5], n_probe=x["n_probe"])
    plain = tbatched.stacked_update(tkind, torch.from_numpy(state0.copy()),
                                    trows, *ta[5:])
    _check(plain.numpy(), xla, exact)


def test_cm_plain_drops_minus_one_rows_where_jax_oracle_wraps():
    """``repro/kernels/ref.py`` adds a ``syn = -1`` tuple into the LAST
    row (``.at[-1]`` wraps). The port drops it; fed ``values = 0`` where
    ``syn = -1``, the JAX oracle agrees."""
    rng = np.random.RandomState(0)
    n, d, w, t = 6, 3, 16, 200
    syn = rng.randint(-1, n, t).astype(np.int32)
    idx = rng.randint(0, w, (t, d)).astype(np.int32)
    vals = rng.randint(1, 5, t).astype(np.float32)
    signs = np.where(rng.rand(t, d) > 0.5, 1.0, -1.0).astype(np.float32)
    counts0 = rng.randint(0, 3, (n, d, w)).astype(np.float32)
    masked = np.where(syn >= 0, vals, 0).astype(np.float32)
    for sg in (None, signs):
        want = np.asarray(jref.onehot_scatter_add(
            jnp.asarray(counts0), jnp.asarray(syn), jnp.asarray(idx),
            jnp.asarray(masked),
            jnp.ones((t, d), jnp.float32) if sg is None else jnp.asarray(sg)))
        got = onehot_matmul.onehot_scatter_add(
            torch.from_numpy(counts0.copy()), torch.from_numpy(syn),
            torch.from_numpy(idx), torch.from_numpy(vals),
            None if sg is None else torch.from_numpy(sg))
        assert np.array_equal(got.numpy(), want)
    wrapped = np.asarray(jref.onehot_scatter_add(
        jnp.asarray(counts0), jnp.asarray(syn), jnp.asarray(idx),
        jnp.asarray(vals), jnp.ones((t, d), jnp.float32)))
    assert not np.array_equal(wrapped[-1], want[-1])    # the hazard is real


@pytest.mark.parametrize("batch", ["empty", "all_minus_one", "uniform",
                                   "zipf"])
def test_runs_of_matches_numpy(batch):
    """``onehot_matmul.runs_of`` (the rows the walk visits, and the longest
    run: the hottest row's add chain) against a numpy bincount of the rows
    in [0, n), with rows -1 and n dropped."""
    rng = np.random.RandomState(7)
    n, t = 500, 20000
    if batch == "empty":
        rows = np.zeros(0, np.int32)
    elif batch == "all_minus_one":
        rows = np.full(t, -1, np.int32)
    else:
        p = 1.0 / np.arange(1, n + 1) ** (1.1 if batch == "zipf" else 0.0)
        rows = rng.choice(n, t, p=p / p.sum()).astype(np.int32)
        rows[rng.rand(t) < 0.1] = -1
        rows[rng.rand(t) < 0.05] = n
    kept = rows[(rows >= 0) & (rows < n)]
    counts = np.bincount(kept, minlength=n)
    want = (int((counts > 0).sum()), int(counts.max()) if kept.size else 0)
    assert onehot_matmul.runs_of(torch.from_numpy(rows), n) == want
    if batch == "zipf":
        assert want[1] > 1000


@pytest.mark.parametrize("batch", ["empty", "zero_weights", "fresh",
                                   "signed_outside"])
def test_element_runs_of_matches_numpy(batch):
    """``onehot_matmul.element_runs_of`` (the elements a small stack's
    batch adds to, and the most entries at one: the element-keyed walk's
    longest add chain) against a numpy count of the (row, depth row,
    bucket) triples that add, leaving out rows -1 and n, buckets outside
    [0, w) and zero weights (signs included)."""
    rng = np.random.RandomState(11)
    n, d, w, t = (1, 5, 64, 20000) if batch == "fresh" else (3, 4, 32, 5000)
    if batch == "empty":
        t = 0
    p = 1.0 / np.arange(1, 501) ** 1.1
    streams = rng.choice(500, t, p=p / p.sum())
    rows = (np.zeros(t) if batch == "fresh" else
            rng.randint(-1, n + 1, t)).astype(np.int32)
    idx = rng.randint(0, w, (500, d)).astype(np.int32)[streams]
    vals = (rng.randint(0, 4, t) * (batch != "zero_weights")).astype(
        np.float32)
    signs = None
    if batch == "signed_outside":
        idx[::7, 1] = rng.choice([-1, w, w + 3], len(idx[::7]))
        signs = np.where(rng.rand(t, d) > 0.5, 1.0, -1.0).astype(np.float32)
    x = vals[:, None] * (1.0 if signs is None else signs)
    adds = ((x != 0) & ((rows >= 0) & (rows < n))[:, None] & (idx >= 0)
            & (idx < w))
    key = ((rows[:, None].astype(np.int64) * d + np.arange(d)) * w + idx)
    _, counts = np.unique(key[adds], return_counts=True)
    want = (len(counts), int(counts.max()) if len(counts) else 0)
    to = lambda a: None if a is None else torch.from_numpy(a)
    assert onehot_matmul.element_runs_of(to(rows), to(idx), to(vals), n, w,
                                         to(signs)) == want
    if batch == "fresh":
        assert want[1] > 1000


@pytest.mark.smoke
def test_hll_plain_matches_jax_oracle():
    rng = np.random.RandomState(1)
    n, m, t = 5, 32, 300
    syn = rng.randint(0, n, t).astype(np.int32)
    bucket = rng.randint(0, m, t).astype(np.int32)
    rank = rng.randint(0, 9, t).astype(np.int32)
    regs0 = rng.randint(0, 4, (n, m)).astype(np.int32)
    want = np.asarray(jref.hll_max_update(jnp.asarray(regs0),
                                          jnp.asarray(syn),
                                          jnp.asarray(bucket),
                                          jnp.asarray(rank)))
    got = hll_max.hll_max_update(torch.from_numpy(regs0.copy()),
                                 torch.from_numpy(syn),
                                 torch.from_numpy(bucket),
                                 torch.from_numpy(rank))
    assert np.array_equal(got.numpy(), want)
    syn[::7] = -1                        # dropped, not wrapped
    got = ref.hll_max_update(torch.from_numpy(regs0.copy()),
                             torch.from_numpy(syn), torch.from_numpy(bucket),
                             torch.from_numpy(rank))
    keep = syn >= 0
    want = np.asarray(jref.hll_max_update(
        jnp.asarray(regs0), jnp.asarray(syn[keep]),
        jnp.asarray(bucket[keep]), jnp.asarray(rank[keep])))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [31, 32])
def test_hll_plain_equals_bitset_plain_at_k1_and_pallas_kernel(seed):
    """The identity the HLL kernels rest on: the register max-scatter is
    the bit-set max-scatter at k = 1 (bucket the position, rank the upd).
    The reference's Pallas kernel (interpret mode), the port's
    ``ref.hll_max_update`` and its wrapper on the CPU, and
    ``ref.bitset_max_update`` on ``bucket[:, None]`` agree byte for byte
    on ranks 0-22, rows -1 and n, buckets -1 and m, and one register
    taking hundreds of tuples with ranks 1-7."""
    n, m, t = 16, 256, 768
    rng = np.random.RandomState(seed)
    syn = rng.randint(0, n, t).astype(np.int32)
    bucket = rng.randint(0, m, t).astype(np.int32)
    rank = rng.randint(0, 23, t).astype(np.int32)
    hot = rng.rand(t) < 0.7
    syn[hot], bucket[hot] = 3, 77
    rank[hot] = rng.randint(1, 8, int(hot.sum()))
    syn[::7], syn[::11] = -1, n
    bucket[::5], bucket[::9] = -1, m
    regs0 = rng.randint(0, 5, (n, m)).astype(np.int32)
    regs0[3, 77] = 2
    kept_hot = hot & (syn == 3) & (bucket == 77)
    assert kept_hot.sum() >= 200
    want = np.asarray(jhll_max.hll_max_update(
        jnp.asarray(regs0), jnp.asarray(syn), jnp.asarray(bucket),
        jnp.asarray(rank), s_tile=8, m_tile=128, t_tile=128, interpret=True))
    args = [torch.from_numpy(a) for a in (syn, bucket, rank)]
    got_ref = ref.hll_max_update(torch.from_numpy(regs0.copy()), *args)
    got_wrap = hll_max.hll_max_update(torch.from_numpy(regs0.copy()), *args)
    got_bits = ref.bitset_max_update(
        torch.from_numpy(regs0.copy()), args[0], args[1][:, None], args[2])
    for got in (got_ref, got_wrap, got_bits):
        assert np.array_equal(got.numpy(), want)
    assert want[3, 77] == rank[kept_hot].max() == 7


def test_hll_wrappers_run_plain_on_cpu_and_launch_nothing():
    """On CPU tensors both HLL wrappers run their plain versions in place
    and count no launch (nor a Bloom or FM one); a tensor on a device
    without a kernel raises."""
    x = _inputs(8, n=8)
    rng = np.random.RandomState(9)
    t = len(x["sids"])
    bucket = rng.randint(0, 32, t).astype(np.int32)
    rank = np.where(x["msk"], rng.randint(1, 23, t), 0).astype(np.int32)
    regs0 = rng.randint(0, 4, (x["n"], 32)).astype(np.int32)
    ta = _torch_args(x)
    rows = tops.route_probe(*ta[:5], n_probe=x["n_probe"])
    tb, tr = torch.from_numpy(bucket), torch.from_numpy(rank)
    counters = lambda: [(f.launches, getattr(f, "one_row_launches", 0))
                        for f in (hll_max.hll_max_update,
                                  hll_max.hll_probe_max_update,
                                  bitset_or.bitset_max_update,
                                  bitset_or.bitset_probe_max_update,
                                  fm_bitmap.fm_bit_update)]
    before = counters()
    want = ref.hll_max_update(torch.from_numpy(regs0.copy()), rows, tb, tr)
    regs = torch.from_numpy(regs0.copy())
    assert hll_max.hll_max_update(regs, rows, tb, tr) is regs
    assert torch.equal(regs, want)
    fresh = torch.zeros((1, 32), dtype=torch.int32)
    hll_max.hll_max_update(fresh, torch.zeros_like(rows), tb, tr)
    regs = torch.from_numpy(regs0.copy())
    assert hll_max.hll_probe_max_update(regs, *ta[:5], tb, tr,
                                        n_probe=x["n_probe"]) is regs
    assert torch.equal(regs, want)
    assert counters() == before
    meta = lambda shape: torch.zeros(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        hll_max.hll_max_update(meta((2, 8)), meta(4), meta(4), meta(4))


def test_operand_checks_raise_before_any_launch():
    """What the CUDA path validates before passing pointers on; a meta
    tensor has no kernel at all."""
    from repro_torch.kernels import build
    dev = torch.device("cpu")
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        build.check(x.float(), "x", torch.int32, (4,), dev)
    with pytest.raises(ValueError, match="shape"):
        build.check(x, "x", torch.int32, (5,), dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.check(torch.zeros((4, 2), dtype=torch.int32).t(), "x",
                    torch.int32, (2, 4), dev)
    with pytest.raises(ValueError, match="power of two"):
        build.check_table(torch.zeros(48, dtype=torch.int32),
                          x, x, x, x, 4, dev)
    with pytest.raises(ValueError, match="no kernel for device"):
        onehot_matmul.onehot_scatter_add(
            torch.zeros((2, 3, 8), device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"),
            torch.zeros((4, 3), dtype=torch.int32, device="meta"),
            torch.zeros(4, device="meta"))


def _bitset_inputs(seed, n, m, t, k):
    """Rows with -1 and out-of-range lanes, positions on both edges of
    [0, m), upd with 0 lanes and one value above 1."""
    rng = np.random.RandomState(seed)
    syn = rng.randint(-1, n + 1, t).astype(np.int32)
    idx = rng.randint(0, m, (t, k)).astype(np.int32)
    idx[::5, 0] = m - 1
    idx[::7, -1] = 0
    upd = (rng.rand(t) > 0.3).astype(np.int32)
    upd[::11] = 2
    bits0 = (rng.rand(n, m) > 0.8).astype(np.int32)
    return syn, idx, upd, bits0


def test_bitset_plain_matches_pallas_kernel():
    """``ref.bitset_max_update`` against ``repro/kernels/bitset_or.py``'s
    kernel (interpret mode) at tile-multiple shapes; both drop -1 rows and
    rows past n, and treat upd 0 as a no-op."""
    n, m, t, k = 16, 256, 384, 3
    syn, idx, upd, bits0 = _bitset_inputs(4, n, m, t, k)
    want = np.asarray(jbitset_or.bitset_max_update(
        jnp.asarray(bits0), jnp.asarray(syn), jnp.asarray(idx),
        jnp.asarray(upd), s_tile=8, m_tile=128, t_tile=128, interpret=True))
    got = bitset_or.bitset_max_update(
        torch.from_numpy(bits0.copy()), torch.from_numpy(syn),
        torch.from_numpy(idx), torch.from_numpy(upd))
    assert np.array_equal(got.numpy(), want)
    oob = idx.copy()
    oob[::3, 1] = m + 5                      # past the row: dropped
    oob[::4, 2] = -2
    got = ref.bitset_max_update(torch.from_numpy(bits0.copy()),
                                torch.from_numpy(syn), torch.from_numpy(oob),
                                torch.from_numpy(upd))
    ok = (oob >= 0) & (oob < m)
    want = bits0.copy()
    for ti in range(t):
        if 0 <= syn[ti] < n and upd[ti] > 0:
            for h in np.flatnonzero(ok[ti]):
                want[syn[ti], oob[ti, h]] = max(want[syn[ti], oob[ti, h]],
                                                upd[ti])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,seed", [(3, 21), (1, 22)])
def test_bitset_plain_matches_pallas_kernel_on_hot_lanes(k, seed):
    """A heavily duplicated batch, as a Zipf stream mix makes it: most
    tuples on two rows and a few lanes (each repeating a lane within its
    k positions where k > 1), upd in {0, 1, 2, 5} in random order, some
    hot lanes already above every upd; the port's CPU path against the
    reference's Pallas kernel (interpret mode)."""
    n, m, t = 16, 256, 384
    rng = np.random.RandomState(seed)
    syn = rng.randint(-1, n + 1, t).astype(np.int32)
    hot = rng.rand(t) < 0.8
    syn[hot] = rng.choice([3, 11], int(hot.sum()))
    lanes = np.array([[5, 200, 5], [5, 77, 131], [255, 0, 255]],
                     np.int32)[:, :k]
    idx = rng.randint(0, m, (t, k)).astype(np.int32)
    idx[hot] = lanes[rng.randint(0, len(lanes), int(hot.sum()))]
    upd = rng.choice(np.array([0, 1, 2, 5], np.int32), t)
    bits0 = (rng.rand(n, m) > 0.9).astype(np.int32)
    bits0[3, 77] = bits0[11, 255] = 9
    want = np.asarray(jbitset_or.bitset_max_update(
        jnp.asarray(bits0), jnp.asarray(syn), jnp.asarray(idx),
        jnp.asarray(upd), s_tile=8, m_tile=128, t_tile=128, interpret=True))
    got = bitset_or.bitset_max_update(
        torch.from_numpy(bits0.copy()), torch.from_numpy(syn),
        torch.from_numpy(idx), torch.from_numpy(upd))
    assert np.array_equal(got.numpy(), want)
    assert want[3, 77] == want[11, 255] == 9
    assert (want[[3, 11]][:, lanes[:, 0]] == 5).any()


@pytest.mark.parametrize("maps,bits", [(8, 16), (1, 32)])
def test_fm_wrappers_match_pallas_and_update_in_place(maps, bits):
    """``fm_bitmap.fm_bit_update`` / ``fm_probe_bit_update`` against the
    reference's (interpret mode): one lane per tuple on the flat plane,
    written through a view of the state."""
    x = _inputs(6, n=8)
    rng = np.random.RandomState(7)
    t = len(x["sids"])
    which = rng.randint(0, maps, t).astype(np.int32)
    pos = rng.randint(0, bits, t).astype(np.int32)
    upd = x["msk"].astype(np.int32)
    state0 = (rng.rand(x["n"], maps, bits) > 0.9).astype(np.int32)
    ja, ta = _jax_args(x), _torch_args(x)
    rows = np.array(jops.route_probe(*ja[:5], n_probe=x["n_probe"]))
    pad = (-t) % 128
    jw, jp, ju = (jnp.asarray(np.pad(a, (0, pad))) for a in (which, pos, upd))
    want = np.asarray(jfm_bitmap.fm_bit_update(
        jnp.asarray(state0), jnp.asarray(np.pad(rows, (0, pad),
                                                constant_values=-1)),
        jw, jp, ju, interpret=True))
    tw, tp, tu = (torch.from_numpy(a) for a in (which, pos, upd))
    state = torch.from_numpy(state0.copy())
    out = fm_bitmap.fm_bit_update(state, torch.from_numpy(rows), tw, tp, tu)
    assert out.data_ptr() == state.data_ptr()
    assert np.array_equal(state.numpy(), want)
    fused = fm_bitmap.fm_probe_bit_update(
        torch.from_numpy(state0.copy()), *ta[:5], tw, tp, tu,
        n_probe=x["n_probe"])
    assert np.array_equal(fused.numpy(), want)
