"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at edge shapes the main path does not reach: tiny and ragged
stacks (n = 1 spreads a block over bucket slices), depths 1 to 30 (deep
sketches stage fewer tuples per chunk in more shared memory), batches
below, at and above one 1024-tuple chunk, count-sketch signs, float
weights; for the bit-set kernel empty batches, k = 1, positions at
m - 1, a probe bound of 1 and a stack past 2**31 lanes, and through it
HLL's registers (a hot register, buckets -1 and m, ranks <= 0); for the RHP
projection ragged plane counts (b = 200 and b = 1), empty batches, rows
out of range, runs just under, at and over the ring walk's threshold,
runs ending on and one past a ring stage, a hot run of ~8k tuples, and
float weights byte-identical to the CPU's serial sum; for CountMin's
small-stack route (d * n < 1024, the data-source fresh sketch; each
entry keyed by its element) n = 1 to 3 at depths 1, 5 and 12, the fresh
sketch's own shape with an element past 8,190 adds, d * n = 1023 and
1020, T = 1 and 33, all weights zero and buckets outside [0, w),
byte-equal to a serial batch-order loop even for float weights; AMS's
registry update at its default depth 12 with +-1 signs, fused and not,
on stacks on both sides of that route, with data-source rows; for its
main path (the row sort, then a walk of each run) runs of 1 to ~8k tuples across chunk boundaries,
interleaved buckets, d = 1 and 30, stacks of 2**17 + 1 and 2**18 + 1 rows,
byte-equal to a serial batch-order loop, and the sort itself against
``torch.sort(stable=True)``; for the sliding-DFT tick S off the
multiples of 4 and 128 up to 2**20 + 7, F = 1 to 33, masks at every
offset from a 16-byte boundary with all, none or only the last row in,
the interleaved in-place planes the engine passes and other shared
strides, byte for byte; for the pairwise correlation N = 1 to 5,001 with
ragged tiles and K from 0 to 64, an ``out`` off its 16-byte alignment,
the same bytes in every run, and an N past 46,341 where N * N passes
2**31; for the attention forward S = 1,
S = 200, Sq != Sk both ways, D = 16 to 256, float32 and bfloat16,
causal and not, the same bytes in two runs, one launch a call, heads
kept apart at a ragged Sk (a neighbour head's K and V all inf), and a
BH * S * D past 2**31; for the reservoir sampler's update empty rows,
rows past the fill (counts above 2**24 and up to 2**31 - 2T), one hot
row, several source rows (one also routed to, one listed twice), runs
within and across a warp's 32 positions, S = 1 to 100, byte for byte,
through both entry points (the probe fused in: a table at 0.7 load, ids
found on the probe's last step or displaced one slot past it); for
Sticky Sampling's update capacities 8, 288 and 4,096, empty, part-filled
and full tables (keys repeated, empty slots holding counts), counts on
both sides of epoch starts, epochs behind and ahead of their counts, a
hot row, several source rows, and the bumps that masked steps take: a
row's last tuple before the batch's last position, at it (the bump then
falls on the next batch's first step, with no tuple of the row) and
followed by masked tuples only, and the walk's hard cases
(STICKY_HARD_PATTERNS: phase 3's traffic, refills after a bump, stretches
that end at an epoch start or cross the int32 wrap, items admitted twice
in a group, sentinel bursts, repeated keys, counts that adds cannot take
in closed form), over two batches, byte for byte, through both entry
points; for GK's requantize m = 8, 400, 1,000, 1,334 and 4,096 (a state
in shared memory) and 8,000 and 20,000 (in global scratch), T = 0 to
65,536, new, idle, out-of-order and hot rows, +inf, -inf and NaN tuples
and state values, counts not whole or near 2**30, data-source rows,
byte for byte, through both entry points, with the kernel's own counts
of rows by path showing each branch taken, and through the engine at
m = 8,000, with a build above the kernel's largest state refused.
Tests marked ``cuda`` need a card; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The tests without the marker hold the plain versions those tests
compare against to a serial loop, on the CPU. This file imports no JAX,
so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (bitset_or, build, flash_attention,
                                 fm_bitmap, gk_requantize, hll_max,
                                 lossy_scan, onehot_matmul, ops,
                                 pairwise_corr, probe, ref, reservoir_scan,
                                 rhp_project, sliding_dft, sticky_scan)
from repro_torch.core import gk, sticky
from repro_torch.service import routing


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _table(rng, n, dev):
    pop = np.unique(rng.randint(0, 2**62, size=2 * n + 8, dtype=np.int64))[:n]
    table = routing.RouteTable()
    table.insert_many(pop, np.arange(n, dtype=np.int32))
    lo, hi = routing.split64(table.keys)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return pop, (t(lo.view(np.int32)), t(hi.view(np.int32)), t(table.rows),
                 routing.next_pow2(table.max_probe))


def _batch(rng, pop, t, dev):
    sids = pop[rng.randint(0, len(pop), t)]
    sids[::5] = (1 << 62) + 12345                    # unrouted
    lo, hi = routing.split64(sids)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return c(lo.view(np.int32)), c(hi.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,w,t", [(1, 5, 2048, 3000), (3, 1, 16, 1),
                                     (204, 5, 64, 1024), (205, 7, 32, 1025),
                                     (1000, 3, 128, 5000),
                                     (3, 30, 16, 2000)])
@pytest.mark.parametrize("signed", [False, True], ids=["cm", "sketch"])
def test_countmin_kernels_match_plain(dev, n, d, w, t, signed):
    rng = np.random.RandomState(n + d + t)
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    slo, shi = _batch(rng, pop, t, dev)
    idx = torch.from_numpy(rng.randint(0, w, (t, d)).astype(np.int32)).to(dev)
    signs = (torch.from_numpy(np.where(rng.rand(t, d) > 0.5, 1.0, -1.0)
                              .astype(np.float32)).to(dev)
             if signed else None)
    rows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    rows[::7] = -1
    counts0 = torch.from_numpy(rng.randint(0, 4, (n, d, w)).astype(
        np.float32)).to(dev)
    for vals in (torch.from_numpy(rng.randint(0, 5, t).astype(np.float32)),
                 torch.from_numpy(rng.rand(t).astype(np.float32) * 3)):
        vals = vals.to(dev)
        want = ref.onehot_scatter_add(counts0.clone(), rows, idx, vals, signs)
        a = onehot_matmul.onehot_scatter_add(counts0.clone(), rows, idx,
                                             vals, signs)
        b = onehot_matmul.onehot_scatter_add(counts0.clone(), rows, idx,
                                             vals, signs)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-4)
        rows_f = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
        want_f = ref.onehot_scatter_add(counts0.clone(), rows_f, idx, vals,
                                        signs)
        got_f = onehot_matmul.onehot_probe_scatter(
            counts0.clone(), klo, khi, trows, slo, shi, idx, vals, signs,
            n_probe=n_probe)
        torch.testing.assert_close(got_f, want_f, rtol=1e-5, atol=1e-4)
    # the integer-valued pass above is exact
    ints = torch.from_numpy(rng.randint(0, 5, t).astype(np.float32)).to(dev)
    assert torch.equal(
        onehot_matmul.onehot_scatter_add(counts0.clone(), rows, idx, ints,
                                         signs),
        ref.onehot_scatter_add(counts0.clone(), rows, idx, ints, signs))


# (n, d, w, t, batch) of the small-stack route (d * n < 1024): n = 1 to 3
# at depths 1, 5 and 12 with rows -1 and n and a hot bucket; the fresh
# sketch itself (65,536 Zipf(1.1) tuples on one row, 10% zero weights, one
# element past 8,190 adds: several whole 512-add steps and a partial one);
# the largest stacks it serves (d * n = 1023, 1020: keys of 21 bits, 3 sort
# passes); T = 1 and 33; all weights zero; buckets outside [0, w)
SMALL_CASES = ([(n, d, 2048, 5000, "mixed") for d in (1, 5, 12)
                for n in (1, 2, 3)] +
               [(1, 5, 2048, 65536, "fresh"), (1023, 1, 2048, 5000, "mixed"),
                (204, 5, 2048, 5000, "mixed"), (1, 5, 2048, 1, "mixed"),
                (2, 5, 2048, 33, "mixed"), (1, 5, 2048, 3000, "zero"),
                (3, 5, 2048, 5000, "outside")])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,w,t,batch", SMALL_CASES,
                         ids=[f"{n}-{d}-{t}-{k}"
                              for n, d, _, t, k in SMALL_CASES])
def test_countmin_small_stack_launch_sums_in_batch_order(dev, n, d, w, t,
                                                        batch):
    """d * n < 1024 takes the element-keyed route (each entry keyed by its
    element, sorted, then walked): integer weights exact, and float
    weights (count-sketch signs too) give the same bytes on two runs and a
    serial loop's bytes in batch order, since every element is summed by
    one thread in that order. (The CPU's ``index_put_`` is no such loop at
    every shape: at n = 3, d = 12 it adds in another order.)"""
    rng = np.random.RandomState(10 * n + d + t)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if batch == "fresh":
        p = 1.0 / np.arange(1, 65537) ** 1.1
        streams = rng.choice(65536, t, p=p / p.sum())
        streams[rng.rand(t) < 0.05] = 0               # the hot stream
        rows = np.zeros(t, np.int32)
        idx = rng.randint(0, w, (65536, d)).astype(np.int32)[streams]
    else:
        rows = rng.randint(-1, n + 1, t).astype(np.int32)
        idx = rng.randint(0, w, (t, d)).astype(np.int32)
        idx[::3] = 77                                 # a hot bucket
    if batch == "outside":
        idx[1::4] = rng.choice([-5, -1, w, w + 7], (len(idx[1::4]), d))
    counts0 = rng.randint(0, 4, (n, d, w)).astype(np.float32)
    signs = np.where(rng.rand(t, d) > 0.5, 1.0, -1.0).astype(np.float32)
    zero = lambda v: v * (rng.rand(t) >= (1.0 if batch == "zero" else 0.1))
    before = onehot_matmul.onehot_scatter_add.one_row_launches
    ints = zero(rng.randint(1, 5, t)).astype(np.float32)
    got = onehot_matmul.onehot_scatter_add(c(counts0), c(rows), c(idx),
                                           c(ints))
    want = _serial_countmin(counts0, rows, idx, ints, None)
    assert got.cpu().numpy().tobytes() == want.tobytes()
    if batch != "outside":             # the plain version keeps no such bucket
        assert torch.equal(got, ref.onehot_scatter_add(c(counts0), c(rows),
                                                       c(idx), c(ints)))
    if batch == "zero":
        assert np.array_equal(want, counts0)
    if batch == "fresh":
        _, longest = onehot_matmul.element_runs_of(c(rows), c(idx), c(ints),
                                                   n, w)
        assert longest > 8190
    for sg in (None, signs):
        vals = zero(rng.rand(t) * 3).astype(np.float32)
        args = (c(rows), c(idx), c(vals), None if sg is None else c(sg))
        a = onehot_matmul.onehot_scatter_add(c(counts0), *args)
        b = onehot_matmul.onehot_scatter_add(c(counts0), *args)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        serial = _serial_countmin(counts0, rows, idx, vals, sg)
        assert a.cpu().numpy().tobytes() == serial.tobytes()
    assert onehot_matmul.onehot_scatter_add.one_row_launches - before == \
        (5 if n == 1 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 5000), (50, 20000), (86, 20000),
                                 (3000, 65536)])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_ams_registry_update_matches_plain(dev, n, t, fuse):
    """AMS's registry update (``ams_scatter``: AMS() at d = 12, w = 2048,
    +-1 signs from ``sign_hash``) against the plain
    ``batched.stacked_update`` on the card, on stacks with d * n below
    1024 (n = 1 and 50: the element-keyed route) and above (86 and 3,000:
    the row sort and walk), a Zipf batch with unrouted and masked tuples,
    and data-source rows fed by the fresh sketch's one-row launch: integer
    weights byte for byte, float weights the same bytes on two runs and
    close to the plain version (whose ``index_put_`` adds in no fixed
    order)."""
    from repro_torch import core
    from repro_torch.core import batched
    kind = core.AMS()
    rng = np.random.RandomState(n + t)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    sids = pop[rng.choice(n, t, p=p / p.sum())]
    sids[::5] = (1 << 62) + 12345                    # unrouted
    lo, hi = routing.split64(sids)
    slo, shi = c(lo.view(np.int32)), c(hi.view(np.int32))
    items = c(routing.fold64(sids).view(np.int32))
    msk = c(rng.rand(t) > 0.1)
    src = c(np.unique([0, n - 1])).long()
    state0 = c(rng.randint(-3, 4, (n, kind.depth, kind.width)).astype(
        np.float32))
    rows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    fn = ops.resolve_update_kernel(kind, fuse)
    wrapper = (onehot_matmul.onehot_probe_scatter if fuse
               else onehot_matmul.onehot_scatter_add)
    signed = lambda: (onehot_matmul.onehot_scatter_add.signed_launches
                      + onehot_matmul.onehot_probe_scatter.signed_launches)
    one_row = lambda: (
        onehot_matmul.onehot_scatter_add.one_row_launches,
        onehot_matmul.onehot_scatter_add.signed_one_row_launches)
    before = (wrapper.launches, one_row(), signed())
    args = (klo, khi, trows, slo, shi, items)
    ints = c(rng.randint(1, 5, t).astype(np.float32))
    got = fn(state0.clone(), *args, ints, msk, src, n_probe=n_probe)
    want = batched.stacked_update(kind, state0.clone(), rows, items, ints,
                                  msk, src)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, state0)
    floats = c((rng.rand(t) * 3).astype(np.float32))
    a = fn(state0.clone(), *args, floats, msk, src, n_probe=n_probe)
    b = fn(state0.clone(), *args, floats, msk, src, n_probe=n_probe)
    want = batched.stacked_update(kind, state0.clone(), rows, items, floats,
                                  msk, src)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-4)
    # three calls: the routed rows' launches and the folds' one-row ones,
    # every one of them signed
    assert wrapper.launches - before[0] == (3 if fuse else 6)
    folds = 6 if n == 1 and not fuse else 3
    assert [x - y for x, y in zip(one_row(), before[1])] == [folds, folds]
    assert signed() - before[2] == 6


DFT_SHAPES = sorted({(1, 1), (37, 1), (1001, 8), (4097, 16), (131073, 8),
                     (2**20 + 7, 8), (2**20 + 7, 33)}
                    | {(s, f) for s in (1, 5, 127, 129)
                       for f in (1, 3, 8, 16, 33)})


def _dft_layouts(vals, dev):
    """Planes [S, F] holding ``vals`` [S, F, 2] at each pair of shared
    strides the tick takes: contiguous planes; the interleaved leaf (im =
    re + 1, element stride 2: the kernel's float2 route), also 4 bytes off
    its 8-byte alignment; element stride 3; transposed planes."""
    s, f, _ = vals.shape
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    re0, im0 = c(vals[..., 0]), c(vals[..., 1])
    leaf = c(vals)
    odd = torch.empty(s * f * 2 + 1, device=dev)[1:].view(s, f, 2)
    odd.copy_(leaf)
    wide = torch.zeros((s, 3 * f + 1), device=dev)
    tr = torch.empty((2, f, s), device=dev)
    out = {"planes": (re0, im0), "interleaved": (leaf[..., 0], leaf[..., 1]),
           "interleaved+4B": (odd[..., 0], odd[..., 1]),
           "stride3": (wide[:, 0:3 * f:3], wide[:, 1:3 * f:3]),
           "transposed": (tr[0].t(), tr[1].t())}
    for name in ("stride3", "transposed"):
        out[name][0].copy_(re0)
        out[name][1].copy_(im0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["random", "all", "none", "last"])
@pytest.mark.parametrize("s,f", DFT_SHAPES)
def test_sliding_dft_kernel_matches_plain_byte_for_byte(dev, s, f,
                                                        mask_kind):
    """In place on contiguous planes, on the interleaved [S, F, 2]
    coefficient leaf's views, as the engine calls it (and 4 bytes off its
    alignment), at element stride 3 and on transposed planes; S off the
    multiples of 4 and of the 128 rows a warp votes on, F up to 33 (> 32:
    the lanes loop over f); the mask a view 0-3 floats past a 16-byte
    boundary; rows masked in at random, all, none, or only the last. The
    kernel rounds every product on its own, so it equals the plain
    version's bytes."""
    rng = np.random.RandomState(s + f)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    vals = (rng.randn(s, f, 2) * 40).astype(np.float32)
    delta = c((rng.randn(s) * 9).astype(np.float32))
    m = {"random": rng.rand(s) > 0.4, "all": np.ones(s, bool),
         "none": np.zeros(s, bool),
         "last": np.arange(s) == s - 1}[mask_kind].astype(np.float32)
    at = {"random": 0, "all": 1, "none": 2, "last": 3}[mask_kind]
    mask = torch.zeros(s + 4, device=dev)[at:at + s]
    mask.copy_(c(m))
    ang = 2 * np.pi * np.arange(1, f + 1) / 128.0
    twr, twi = c(np.cos(ang).astype(np.float32)), c(np.sin(ang).astype(
        np.float32))
    want = ref.sliding_dft_step(c(vals[..., 0]), c(vals[..., 1]), delta,
                                mask, twr, twi)
    layouts = _dft_layouts(vals, dev)
    before = sliding_dft.sliding_dft_step.launches
    for name, (re, im) in layouts.items():
        got = sliding_dft.sliding_dft_step(re, im, delta, mask, twr, twi)
        assert got[0] is re and got[1] is im, name
    torch.cuda.synchronize()
    assert sliding_dft.sliding_dft_step.launches - before == len(layouts)
    for name, (re, im) in layouts.items():
        for g, w in zip((re, im), want):
            assert torch.equal(g.contiguous().view(torch.int32),
                               w.view(torch.int32)), name
    if mask_kind == "none":
        assert torch.equal(want[0], c(vals[..., 0]))


@pytest.mark.cuda
def test_sliding_dft_wrapper_counts_launches_and_rejects_bad_operands(dev):
    re = torch.zeros((5, 3), device=dev)
    s1 = torch.zeros(5, device=dev)
    tw = torch.ones(3, device=dev)
    fn = sliding_dft.sliding_dft_step
    before = fn.launches
    fn(re, re.clone(), s1, s1, tw, tw)
    fn(re[:0], re[:0], s1[:0], s1[:0], tw, tw)          # S = 0: no launch
    assert fn.launches == before + 1
    with pytest.raises(ValueError, match="is on cpu"):
        fn(re, re, s1.cpu(), s1, tw, tw)
    with pytest.raises(TypeError):
        fn(re, re, s1.double(), s1, tw, tw)
    with pytest.raises(ValueError, match="share strides"):
        fn(re, re.t().contiguous().t(), s1, s1, tw, tw)
    with pytest.raises(ValueError, match="shape"):
        fn(re, re, s1, s1, tw[:2], tw)
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,t", [(1, 16, 1), (7, 64, 1000),
                                   (300, 2048, 70000)])
def test_hll_kernels_match_plain(dev, n, m, t):
    rng = np.random.RandomState(n + m)
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    slo, shi = _batch(rng, pop, t, dev)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bucket = c(rng.randint(0, m, t).astype(np.int32))
    rank = c(rng.randint(0, 12, t).astype(np.int32))
    regs0 = c(rng.randint(0, 5, (n, m)).astype(np.int32))
    rows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    want = ref.hll_max_update(regs0.clone(), rows, bucket, rank)
    got = hll_max.hll_max_update(regs0.clone(), rows, bucket, rank)
    got_f = hll_max.hll_probe_max_update(regs0.clone(), klo, khi, trows, slo,
                                         shi, bucket, rank, n_probe=n_probe)
    assert torch.equal(got, want) and torch.equal(got_f, want)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_cpu_operands(dev):
    counts = torch.zeros((4, 2, 8), device=dev)
    rows = torch.zeros(3, dtype=torch.int32, device=dev)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    vals = torch.ones(3, device=dev)
    before = onehot_matmul.onehot_scatter_add.launches
    onehot_matmul.onehot_scatter_add(counts, rows, idx, vals)
    assert onehot_matmul.onehot_scatter_add.launches == before + 1
    with pytest.raises(ValueError, match="is on cpu"):
        onehot_matmul.onehot_scatter_add(counts, rows.cpu(), idx, vals)
    with pytest.raises(TypeError):
        onehot_matmul.onehot_scatter_add(counts, rows, idx, vals.double())
    assert onehot_matmul.onehot_scatter_add.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,t,k", [(1, 16, 0, 11), (1, 16, 300, 2),
                                     (5, 64, 1, 1),
                                     (7, 128, 1000, 1), (3, 8, 500, 40),
                                     (300, 16384, 70000, 11),
                                     (65537, 32768, 4000, 3)])
def test_bitset_kernels_match_plain(dev, n, m, t, k):
    """n = 1 makes a table whose probe bound is 1; the last shape holds
    2**31 + 2**15 lanes: its upper rows need 64-bit offsets."""
    rng = np.random.RandomState(n + m + k)
    pop, (klo, khi, trows, n_probe) = _table(rng, min(n, 4096), dev)
    assert n > 1 or n_probe == 1
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if t:
        slo, shi = _batch(rng, pop, t, dev)
    else:
        slo = shi = torch.zeros(0, dtype=torch.int32, device=dev)
    idx = rng.randint(0, m, (t, k)).astype(np.int32)
    idx[::3, 0] = m - 1
    idx, upd = c(idx), c(rng.randint(0, 3, t).astype(np.int32))
    bits0 = torch.zeros((n, m), dtype=torch.int32, device=dev)
    bits0[: min(n, 64)] = c((rng.rand(min(n, 64), m) > 0.9).astype(np.int32))
    rows = c(rng.randint(-1, n + 1, t).astype(np.int32))
    rows[::4] = n - 1
    want = ref.bitset_max_update(bits0.clone(), rows, idx, upd)
    got = bitset_or.bitset_max_update(bits0.clone(), rows, idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del got, want
    # fused: the table's rows reach the first 4096 rows only
    rows_f = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    want = ref.bitset_max_update(bits0.clone(), rows_f, idx, upd)
    got = bitset_or.bitset_probe_max_update(bits0.clone(), klo, khi, trows,
                                            slo, shi, idx, upd,
                                            n_probe=n_probe)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bitset_probe_bound_of_one(dev):
    """With n_probe = 1, ids displaced from their start slot resolve to
    -1 in the kernel as in the plain probe."""
    rng = np.random.RandomState(11)
    pop, (klo, khi, trows, n_probe) = _table(rng, 3000, dev)
    assert n_probe > 1
    slo, shi = _batch(rng, pop, 20000, dev)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    idx = c(rng.randint(0, 512, (20000, 4)).astype(np.int32))
    upd = torch.ones(20000, dtype=torch.int32, device=dev)
    bits0 = torch.zeros((3000, 512), dtype=torch.int32, device=dev)
    rows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=1)
    assert int((rows < 0).sum()) > 20000 // 5        # displaced ids drop
    want = ref.bitset_max_update(bits0.clone(), rows, idx, upd)
    got = bitset_or.bitset_probe_max_update(bits0.clone(), klo, khi, trows,
                                            slo, shi, idx, upd, n_probe=1)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,maps,bits,t", [(1, 1, 32, 300), (131, 64, 32,
                                                             5000),
                                           (9, 8, 16, 0)])
def test_fm_kernels_match_plain(dev, n, maps, bits, t):
    rng = np.random.RandomState(n + maps + t)
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if t:
        slo, shi = _batch(rng, pop, t, dev)
    else:
        slo = shi = torch.zeros(0, dtype=torch.int32, device=dev)
    which = c(rng.randint(0, maps, t).astype(np.int32))
    pos = rng.randint(0, bits, t).astype(np.int32)
    pos[::5] = bits - 1
    pos, upd = c(pos), c((rng.rand(t) > 0.2).astype(np.int32))
    state0 = c((rng.rand(n, maps, bits) > 0.9).astype(np.int32))
    rows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    flat_pos = (which * bits + pos)[:, None].contiguous()
    want = ref.bitset_max_update(state0.clone().view(n, -1), rows, flat_pos,
                                 upd).view(n, maps, bits)
    got = fm_bitmap.fm_bit_update(state0.clone(), rows, which, pos, upd)
    got_f = fm_bitmap.fm_probe_bit_update(state0.clone(), klo, khi, trows,
                                          slo, shi, which, pos, upd,
                                          n_probe=n_probe)
    assert torch.equal(got, want) and torch.equal(got_f, want)


def _hot_batch(rng, pop, n, m, t, k, dev):
    """A batch whose tuples mostly hit one stream: its rows and stream-id
    halves, positions (the hot stream's k lanes, the first repeated as
    the last where k > 1; every 5th tuple's first position -1, every 9th
    one's last m) and upd from 1 to 7 in random order with some 0 and
    -3; rows -1, n and n + 5 on every 7th, 11th and 13th tuple."""
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    hot = rng.rand(t) < 0.7
    which = rng.randint(0, len(pop), t)
    which[hot] = 1
    sids = pop[which]
    sids[::6] = (1 << 62) + 12345                    # unrouted
    rows = which.astype(np.int32)
    rows[::7], rows[::11], rows[::13] = -1, n, n + 5
    lanes = rng.randint(0, m, k).astype(np.int32)
    lanes[-1] = lanes[0]
    idx = rng.randint(0, m, (t, k)).astype(np.int32)
    idx[hot] = lanes
    idx[::5, 0] = -1
    idx[::9, -1] = m
    upd = rng.randint(1, 8, t).astype(np.int32)
    upd[::17], upd[::19] = 0, -3
    lo, hi = routing.split64(sids)
    return (c(rows), c(lo.view(np.int32)), c(hi.view(np.int32)), c(idx),
            c(upd), lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("k,t", [(1, 1), (3, 31), (11, 33), (40, 1),
                                 (1, 4099), (3, 4099), (11, 4099),
                                 (40, 4099), (49, 33), (64, 4099)])
@pytest.mark.parametrize("state", ["zero", "set"])
def test_bitset_kernels_hot_lanes_match_plain_byte_for_byte(dev, k, t, state):
    """Thousands of tuples on one (row, lane) with upd 1 to 7, a lane
    already above every upd (``set``: the batch's state after a first
    run, its hot lanes at 9), a tuple's k positions repeating a lane,
    T not a multiple of 32, rows and positions outside the stack; k = 49
    and 64 read positions from global memory, not shared; both entry
    points, twice each."""
    rng = np.random.RandomState(k * 10007 + t)
    n, m = 40, 512
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    rows, slo, shi, idx, upd, lanes = _hot_batch(rng, pop, n, m, t, k, dev)
    bits0 = torch.zeros((n, m), dtype=torch.int32, device=dev)
    if state == "set":
        bits0 = ref.bitset_max_update(bits0, rows, idx, upd)
        bits0[1, int(lanes[0])] = 9
    rows_f = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    for label, kern, plain_rows in (
            ("rows given", lambda s: bitset_or.bitset_max_update(
                s, rows, idx, upd), rows),
            ("probe fused", lambda s: bitset_or.bitset_probe_max_update(
                s, klo, khi, trows, slo, shi, idx, upd, n_probe=n_probe),
             rows_f)):
        want = ref.bitset_max_update(bits0.clone(), plain_rows, idx, upd)
        got = [kern(bits0.clone()) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], want), label
        assert torch.equal(got[1], got[0]), label
    if state == "set":
        assert int(want[1, int(lanes[0])]) == 9


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 31, 33, 4099])
@pytest.mark.parametrize("state", ["zero", "set"])
def test_fm_kernels_hot_lanes_match_plain_byte_for_byte(dev, t, state):
    """FM's two wrappers (k = 1 on the flat plane) on a batch whose tuples
    mostly hit one stream's one lane, upd 1 to 7, ``which`` past the
    maps on some tuples (a flat position past m), twice each."""
    rng = np.random.RandomState(t + 3)
    n, maps, bits = 40, 16, 32
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    rows, slo, shi, flat, upd, lanes = _hot_batch(rng, pop, n, maps * bits,
                                                  t, 1, dev)
    flat = flat[:, 0].clamp(min=0)
    which, pos = flat // bits, flat % bits
    state0 = torch.zeros((n, maps, bits), dtype=torch.int32, device=dev)
    if state == "set":
        ref.bitset_max_update(state0.view(n, -1), rows, flat[:, None], upd)
        state0.view(n, -1)[1, int(lanes[0])] = 9
    rows_f = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    for label, kern, plain_rows in (
            ("rows given", lambda s: fm_bitmap.fm_bit_update(
                s, rows, which, pos, upd), rows),
            ("probe fused", lambda s: fm_bitmap.fm_probe_bit_update(
                s, klo, khi, trows, slo, shi, which, pos, upd,
                n_probe=n_probe), rows_f)):
        want = ref.bitset_max_update(state0.clone().view(n, -1), plain_rows,
                                     flat[:, None].contiguous(), upd)
        got = [kern(state0.clone()) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(n, -1), want), label
        assert torch.equal(got[1], got[0]), label


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 31, 33, 4099])
@pytest.mark.parametrize("state", ["zero", "set"])
def test_hll_kernels_hot_registers_match_plain_byte_for_byte(dev, t, state):
    """HLL's two wrappers (the bit-set kernel at k = 1) on a batch whose
    tuples mostly hit one stream's one register with ranks 1 to 7 (some
    0 and -3), buckets -1 and m, rows -1, n and n + 5; ``set``: the
    batch's state after a first run with the hot register at 9, above
    every rank; twice each."""
    rng = np.random.RandomState(t + 5)
    n, m = 40, 2048
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    rows, slo, shi, pos, rank, lanes = _hot_batch(rng, pop, n, m, t, 1, dev)
    bucket = pos[:, 0].contiguous()
    regs0 = torch.zeros((n, m), dtype=torch.int32, device=dev)
    if state == "set":
        ref.hll_max_update(regs0, rows, bucket, rank)
        regs0[1, int(lanes[0])] = 9
    rows_f = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    for label, kern, plain_rows in (
            ("rows given", lambda s: hll_max.hll_max_update(
                s, rows, bucket, rank), rows),
            ("probe fused", lambda s: hll_max.hll_probe_max_update(
                s, klo, khi, trows, slo, shi, bucket, rank,
                n_probe=n_probe), rows_f)):
        want = ref.hll_max_update(regs0.clone(), plain_rows, bucket, rank)
        got = [kern(regs0.clone()) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], want), label
        assert torch.equal(got[1], got[0]), label
    if state == "set":
        assert int(want[1, int(lanes[0])]) == 9


@pytest.mark.cuda
def test_hll_wrappers_count_their_own_launches(dev):
    """The HLL wrappers launch the bit-set kernel but count on their own
    counters (the fresh sketch's one-row launches too), never on Bloom's
    or FM's; an empty batch launches nothing, a bad operand raises before
    any launch."""
    rng = np.random.RandomState(12)
    pop, (klo, khi, trows, n_probe) = _table(rng, 4, dev)
    slo, shi = _batch(rng, pop, 3, dev)
    regs = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    rows = torch.zeros(3, dtype=torch.int32, device=dev)
    bucket = torch.tensor([1, 5, 63], dtype=torch.int32, device=dev)
    rank = torch.tensor([3, 1, 2], dtype=torch.int32, device=dev)
    hll, hllp = hll_max.hll_max_update, hll_max.hll_probe_max_update
    others = lambda: (bitset_or.bitset_max_update.launches,
                      bitset_or.bitset_max_update.one_row_launches,
                      bitset_or.bitset_probe_max_update.launches,
                      fm_bitmap.fm_bit_update.launches,
                      fm_bitmap.fm_bit_update.one_row_launches,
                      fm_bitmap.fm_probe_bit_update.launches)
    h0, o0, p0, b0 = hll.launches, hll.one_row_launches, hllp.launches, \
        others()
    hll(regs, rows, bucket, rank)
    hll(regs[:1], rows, bucket, rank)                     # a fresh sketch
    hllp(regs, klo, khi, trows, slo, shi, bucket, rank, n_probe=n_probe)
    empty = rows[:0]
    hll(regs, empty, empty, empty)
    hllp(regs, klo, khi, trows, empty, empty, empty, empty, n_probe=n_probe)
    torch.cuda.synchronize()
    assert (hll.launches, hll.one_row_launches, hllp.launches) == (
        h0 + 2, o0 + 1, p0 + 1)
    assert others() == b0
    assert int(regs[0, 1]) == 3 and int(regs[0, 63]) == 2
    with pytest.raises(ValueError, match="is on cpu"):
        hll(regs, rows, bucket.cpu(), rank)
    with pytest.raises(TypeError):
        hll(regs, rows, bucket, rank.long())
    with pytest.raises(ValueError, match="shape"):
        hllp(regs, klo, khi, trows, slo, shi, bucket[:2], rank,
             n_probe=n_probe)
    assert (hll.launches, hllp.launches) == (h0 + 2, p0 + 1)


@pytest.mark.cuda
def test_bitset_and_fm_wrappers_count_their_own_launches(dev):
    bits = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    rows = torch.zeros(3, dtype=torch.int32, device=dev)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    upd = torch.ones(3, dtype=torch.int32, device=dev)
    fm = fm_bitmap.fm_bit_update
    b0, f0, f1 = (bitset_or.bitset_max_update.launches, fm.launches,
                  fm.one_row_launches)
    bitset_or.bitset_max_update(bits, rows, idx, upd)
    fm(bits.view(4, 8, 8), rows, rows, rows, upd)
    fm(bits[:1].view(1, 8, 8), rows, rows, rows, upd)     # a fresh sketch
    assert bitset_or.bitset_max_update.launches == b0 + 1
    assert (fm.launches, fm.one_row_launches) == (f0 + 2, f1 + 1)
    with pytest.raises(ValueError, match="is on cpu"):
        bitset_or.bitset_max_update(bits, rows.cpu(), idx, upd)
    with pytest.raises(TypeError):
        bitset_or.bitset_max_update(bits, rows, idx, upd.long())
    assert bitset_or.bitset_max_update.launches == b0 + 1


def _run_rows(rng, n, lengths, noise, invalid):
    """Rows [T] i32 in batch order: one run of each length in ``lengths``
    (the first on row 0, the last on row n - 1, the rest on distinct rows
    between), ``noise`` tuples spread over the other rows, and, where
    ``invalid``, rows -1 and n; shuffled, so the stable sort matters."""
    used = list(rng.choice(np.arange(1, n - 1), len(lengths), replace=False))
    used[0], used[-1] = 0, n - 1
    rows = [np.full(k, r) for k, r in zip(lengths, used)]
    rows.append(rng.choice(np.setdiff1d(np.arange(n), used), noise))
    if invalid:
        rows += [np.full(37, -1), np.full(41, n)]
    rows = np.concatenate(rows).astype(np.int32)
    rng.shuffle(rows)
    return rows


L, RR = rhp_project.LONG_RUN, rhp_project.RING_ROWS
# (n, b, t, run lengths): random rows as before where no runs are given;
# else several runs over LONG_RUN, one of exactly LONG_RUN and one of
# LONG_RUN - 1, a run that ends on a ring-stage boundary and one that ends
# one past it (the first run, on row 0, starts the sorted batch where no
# row is -1, so its stages start at 0), and a hot run of ~8k tuples at
# ragged widths
RHP_CASES = [(1, 64, 300, None), (5, 1, 77, None), (16, 200, 513, None),
             (9, 33, 0, None), (300, 64, 70001, None), (2, 64, 5000, None),
             (16, 64, 0, [3 * RR, L - 1, L, L + 1, 3 * RR + 1, 1000, 3, 1]),
             (16, 64, 0, [3 * RR + 1, L, 2 * RR - 1, 40]),
             (64, 64, 0, [8299, 3777, 2409, 300, L, 40]),
             (64, 1, 0, [8299, 3777, 2409, 300, L, 40]),
             (64, 33, 0, [8299, 3777, 2409, 300, L, 40]),
             (64, 200, 0, [8299, 3777, 2409, 300, L, 40])]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,b,t,runs", RHP_CASES,
    ids=[f"{n}-{b}-{t}" if runs is None else f"{n}-{b}-runs{len(runs)}"
         for n, b, t, runs in RHP_CASES])
def test_rhp_kernels_match_plain(dev, n, b, t, runs):
    """Rows -1 and n dropped; b = 1, 33 and 200 leave a ragged lane
    slice; t = 0 launches nothing; n = 2 with t = 5000 makes runs of
    thousands of tuples. Cases with ``runs`` place runs of given lengths
    around the ring walk's threshold and stage size (rows -1 and n only at
    b != 64, so the b = 64 hot run starts the sorted batch and the last
    run ends it). The kernels add each row's tuples in batch order, as
    the plain version does on the CPU (``index_add_`` there walks the
    batch in order), so even float weights give the CPU's bytes; the
    card's ``index_add_`` adds in no fixed order. The long-run count
    moves by the runs of at least LONG_RUN tuples, and only by them."""
    rng = np.random.RandomState(n + b + t + len(runs or ()))
    pop, (klo, khi, trows, n_probe) = _table(rng, n, dev)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if runs is not None:
        rows_np = _run_rows(rng, n, runs, noise=5 * n, invalid=b != 64)
        t = rows_np.shape[0]
        sids = np.where((rows_np >= 0) & (rows_np < n),
                        pop[np.clip(rows_np, 0, n - 1)], (1 << 62) + 12345)
        lo, hi = routing.split64(sids)
        slo, shi = c(lo.view(np.int32)), c(hi.view(np.int32))
    elif t:
        slo, shi = _batch(rng, pop, t, dev)
    else:
        slo = shi = torch.zeros(0, dtype=torch.int32, device=dev)
    signs = c(np.where(rng.rand(t, b) > 0.5, 1.0, -1.0).astype(np.float32))
    if runs is None:
        rows_np = rng.randint(-1, n + 1, t).astype(np.int32)
    rows = c(rows_np)
    prows = probe.probe_rows(klo, khi, trows, slo, shi, n_probe=n_probe)
    n_long = rhp_project.long_runs_of(rows, n)[0]
    n_long_f = rhp_project.long_runs_of(prows, n)[0]
    if runs is not None:
        assert n_long == n_long_f == sum(k >= L for k in runs)
    state0 = c(rng.randint(-3, 4, (n, b)).astype(np.float32))
    proj, fused = rhp_project.rhp_project_update, rhp_project.rhp_probe_update
    before = proj.launches
    walked0 = (int(proj.long_runs), int(fused.long_runs))
    for vals in (c(rng.randint(0, 5, t).astype(np.float32)),
                 c(rng.randn(t).astype(np.float32) * 3)):
        want = ref.rhp_project_update(state0.clone(), rows, vals, signs)
        a = proj(state0.clone(), rows, vals, signs)
        # read on the caller's stream straight after the call: the walks'
        # second stream has joined it
        b2 = proj(state0.clone(), rows, vals, signs).clone()
        want_f = ref.rhp_probe_update(state0.clone(), klo, khi, trows, slo,
                                      shi, vals, signs, n_probe=n_probe)
        got_f = fused(state0.clone(), klo, khi, trows, slo, shi, vals, signs,
                      n_probe=n_probe)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b2.view(torch.int32))
        torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got_f, want_f, rtol=1e-4, atol=1e-3)
        cpu = [x.cpu() for x in (state0, rows, vals, signs)]
        serial = ref.rhp_project_update(cpu[0].clone(), *cpu[1:])
        assert torch.equal(a.cpu().view(torch.int32),
                           serial.view(torch.int32))
        assert torch.equal(got_f.cpu().view(torch.int32),
                           ref.rhp_project_update(
                               cpu[0].clone(), prows.cpu(),
                               *cpu[2:]).view(torch.int32))
    # integer weights: exact, both entry points
    ints = c(rng.randint(-4, 5, t).astype(np.float32))
    assert torch.equal(proj(state0.clone(), rows, ints, signs),
                       ref.rhp_project_update(state0.clone(), rows, ints,
                                              signs))
    assert torch.equal(
        fused(state0.clone(), klo, khi, trows, slo, shi, ints, signs,
              n_probe=n_probe),
        ref.rhp_probe_update(state0.clone(), klo, khi, trows, slo, shi, ints,
                             signs, n_probe=n_probe))
    launched = proj.launches - before
    assert launched == (5 if t else 0)
    assert (int(proj.long_runs) - walked0[0],
            int(fused.long_runs) - walked0[1]) == (5 * n_long, 3 * n_long_f)


@pytest.mark.cuda
def test_rhp_wrappers_count_launches_and_reject_bad_operands(dev):
    state = torch.zeros((4, 64), device=dev)
    rows = torch.tensor([0, 3, -1], dtype=torch.int32, device=dev)
    vals = torch.ones(3, device=dev)
    signs = torch.ones((3, 64), device=dev)
    fn = rhp_project.rhp_project_update
    l0, r0 = fn.launches, fn.one_row_launches
    fn(state, rows, vals, signs)
    fn(state[:1], torch.zeros(3, dtype=torch.int32, device=dev), vals, signs)
    assert (fn.launches, fn.one_row_launches) == (l0 + 2, r0 + 1)
    with pytest.raises(ValueError, match="is on cpu"):
        fn(state, rows.cpu(), vals, signs)
    with pytest.raises(ValueError, match="shape"):
        fn(state, rows, vals, signs[:, :32].contiguous())
    with pytest.raises(TypeError):
        fn(state, rows, vals.double(), signs)
    assert fn.launches == l0 + 2


def _serial_countmin(counts0, rows, idx, vals, signs):
    """The batch's adds one at a time, in batch order, in float32
    (``np.add.at`` adds repeated indices in order); zero weights and
    buckets outside [0, w) skipped, as the kernels skip them."""
    n, d, w = counts0.shape
    out = counts0.copy().reshape(-1)
    keep = (rows >= 0) & (rows < n)
    for j in range(d):
        v = vals if signs is None else (vals * signs[:, j]).astype(np.float32)
        k = keep & (v != 0) & (idx[:, j] >= 0) & (idx[:, j] < w)
        np.add.at(out, (rows[k].astype(np.int64) * d + j) * w + idx[k, j],
                  v[k])
    return out.reshape(counts0.shape)


# (n, d, w, run lengths or a Zipf batch of t tuples): runs of 1 to 257 and
# ~8k tuples (crossing 32-position chunks everywhere, rows -1 and n
# between), a Zipf(1.1) batch whose hot rows spread over 3 interleaved
# buckets, d = 1 and d = 30 with T no multiple of 32, and the stacks whose
# rows take 17 and 19 bits (n = 2**17 + 1, 2**18 + 1: 2 and 3 sort passes)
CM_CASES = [(64, 5, 64, [8190, 1, 31, 32, 33, 255, 256, 257, 40]),
            (300, 5, 2048, 20000), (2048, 1, 64, 4987), (64, 30, 16, 3001),
            (2**17 + 1, 1, 16, [9000, 33, 1]), (2**18 + 1, 2, 8, 9001)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,w,spec", CM_CASES,
                         ids=[f"{n}-{d}-{w}" for n, d, w, _ in CM_CASES])
@pytest.mark.parametrize("signed", [False, True], ids=["cm", "sketch"])
def test_countmin_walk_sums_in_batch_order(dev, n, d, w, spec, signed):
    """The main path (d * n >= 1024: the row sort, then one warp per 32
    sorted positions and depth row): integer weights exact; float weights
    the same bytes on two runs and a serial batch-order loop's bytes, for
    both entry points, with one launch a call. Several runs cross each
    32-position chunk; the hot rows' buckets interleave, so a step holds
    several elements and the carried one comes and goes."""
    rng = np.random.RandomState(n + d + w)
    pop, (klo, khi, trows, n_probe) = _table(rng, min(n, 4096), dev)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if isinstance(spec, list):
        rows = _run_rows(rng, min(n, 4096), spec, noise=300, invalid=True)
        rows = np.where(rows == min(n, 4096) - 1, n - 1, rows)   # top row
        rows = np.where(rows == min(n, 4096), n, rows).astype(np.int32)
    else:
        p = 1.0 / np.arange(1, n + 1) ** 1.1
        rows = rng.choice(n, spec, p=p / p.sum()).astype(np.int32)
        rows[rng.rand(spec) < 0.05] = -1
        rows[rng.rand(spec) < 0.05] = n
    t = rows.shape[0]
    # a stream's buckets, or (Zipf batches) one of 3 per row, interleaved
    idx = (rows[:, None].astype(np.int64) * 7919 + 13 * np.arange(d)) % w
    if not isinstance(spec, list):
        idx = (idx + rng.randint(0, 3, (t, 1))) % w
    idx = idx.astype(np.int32)
    signs = (np.where(rng.rand(t, d) > 0.5, 1.0, -1.0).astype(np.float32)
             if signed else None)
    # the fused entry: routed ids for the rows of the table's stack (rows
    # -1 and n and the rows past it unrouted)
    fused = n <= 4096
    if fused:
        sids = np.where((rows >= 0) & (rows < n),
                        pop[np.clip(rows, 0, n - 1)], (1 << 62) + 12345)
        lo, hi = routing.split64(sids)
        slo, shi = c(lo.view(np.int32)), c(hi.view(np.int32))
    counts0 = rng.randint(0, 4, (n, d, w)).astype(np.float32)
    sg = None if signs is None else c(signs)
    scatter = onehot_matmul.onehot_scatter_add
    probe_scatter = onehot_matmul.onehot_probe_scatter
    l0, f0 = scatter.launches, probe_scatter.launches
    ints = rng.randint(0, 5, t).astype(np.float32)
    got = scatter(c(counts0), c(rows), c(idx), c(ints), sg)
    assert torch.equal(got, ref.onehot_scatter_add(c(counts0), c(rows),
                                                   c(idx), c(ints), sg))
    vals = (rng.rand(t) * 3).astype(np.float32)
    vals[rng.rand(t) < 0.05] = 0.0
    want = _serial_countmin(counts0, rows, idx, vals, signs)
    a = scatter(c(counts0), c(rows), c(idx), c(vals), sg)
    b = scatter(c(counts0), c(rows), c(idx), c(vals), sg)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert a.cpu().numpy().tobytes() == want.tobytes()
    if fused:
        got_f = probe_scatter(c(counts0), klo, khi, trows, slo, shi, c(idx),
                              c(vals), sg, n_probe=n_probe)
        assert got_f.cpu().numpy().tobytes() == want.tobytes()
    assert (scatter.launches - l0, probe_scatter.launches - f0) == \
        (3, int(fused))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 100), (2, 1), (1000, 5000),
                                 (2**17, 65536), (2**17 + 1, 70001),
                                 (2**18 + 1, 9000)])
def test_countmin_row_sort_matches_torch_stable_sort(dev, n, t):
    """The hand-written sort against ``torch.sort(stable=True)`` of the
    rows in [0, n) (the yardstick, in a test only): the same rows, and
    equal rows in batch order. Zipf rows, with -1, n and the top row."""
    rng = np.random.RandomState(n + t)
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    rows = rng.choice(n, t, p=p / p.sum()).astype(np.int32)
    rows[rng.rand(t) < 0.05] = -1
    rows[rng.rand(t) < 0.05] = n
    rows[::101] = n - 1
    r = torch.from_numpy(rows).to(dev)
    srow, perm = onehot_matmul.sort_rows(r, n)
    keep = (r >= 0) & (r < n)
    want_rows, order = torch.sort(r[keep], stable=True)
    assert torch.equal(srow, want_rows)
    assert torch.equal(perm.long(), torch.nonzero(keep)[:, 0][order])


# the float32 Gram of x ~ 0.1 N(0, 1) over K <= 40 terms, summed in
# another order than the plain version's matrix product: a few ulp of
# values below 1
CORR_ATOL = 1e-5


CORR_SHAPES = sorted({(1, 1), (37, 3), (64, 16), (300, 16), (512, 40),
                      (5000, 16)}
                     | {(n, k) for n in (1, 3, 63, 65, 127, 4097, 5000, 5001)
                        for k in (0, 1, 3, 16, 33, 64)})


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", CORR_SHAPES)
def test_pairwise_corr_kernel_matches_plain(dev, n, k):
    """Against the plain version to CORR_ATOL; the same bytes in two runs
    and in a third into an ``out`` 4 bytes past a 16-byte boundary (the
    streaming stores, where the aligned run of an N % 4 == 0 takes the 2-D
    TMA store); the diagonal 1 and the matrix symmetric, bit for bit (sq is
    summed with the products' own order). N off the 128 x 64 tiles, K = 0
    and K past one 16-wide chunk of K."""
    rng = np.random.RandomState(n + k)
    x = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32)).to(dev)
    want = ref.pairwise_corr(x)
    got = pairwise_corr.pairwise_corr(x)
    again = pairwise_corr.pairwise_corr(x)
    off = torch.full((n * n + 1,), float("nan"), device=dev)[1:].view(n, n)
    assert off.data_ptr() % 16 == 4
    assert pairwise_corr.pairwise_corr(x, off) is off
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= CORR_ATOL
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32), off.view(torch.int32))
    assert torch.equal(got.diagonal(), torch.ones(n, device=dev))
    assert torch.equal(got.view(torch.int32), got.T.view(torch.int32))


@pytest.mark.cuda
def test_pairwise_corr_wrapper_counts_launches_and_rejects_bad_operands(dev):
    x = torch.randn((70, 5), device=dev)
    fn = pairwise_corr.pairwise_corr
    before = fn.launches
    out = torch.full((70, 70), float("nan"), device=dev)
    assert fn(x, out) is out and not bool(out.isnan().any())
    assert fn(x[:0]).shape == (0, 0)                    # N = 0: no launch
    got = ops.corr_matrix(x.reshape(70, 5, 1).double())    # cast, flatten
    assert fn.launches == before + 2
    assert torch.equal(got, out)
    with pytest.raises(ValueError, match="is on cpu"):
        fn(x, out.cpu())
    with pytest.raises(TypeError):
        fn(x.double())
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        fn(x.reshape(70, 5, 1))
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        fn(x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        fn(x, out[:69])
    assert fn.launches == before + 2


@pytest.mark.cuda
def test_pairwise_corr_64_bit_offsets(dev):
    """N = 46,400, K = 2: N * N = 2.15e9 elements (8.6 GB), past 2**31.
    The last 64 rows against the plain formula computed for those rows
    alone, and the first row too."""
    n, k, tail = 46400, 2, 64
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32)).to(dev)
    out = pairwise_corr.pairwise_corr(x)
    sq = torch.sum(x * x, dim=-1)
    for rows in (slice(n - tail, n), slice(0, 1)):
        want = 1.0 - (sq[rows, None] + sq[None, :] - 2.0 * (x[rows] @ x.T))
        assert float((out[rows] - want).abs().max()) <= CORR_ATOL
    assert float(out[-1, -1]) == 1.0 and float(out[-1, 0]) == float(out[0, -1])
    del out
    torch.cuda.empty_cache()


def _attn_inputs(rng, bh, sq, sk, d, dtype, dev, qk_scale=0.3):
    q = rng.randn(bh, sq, d).astype(np.float32) * qk_scale
    k = rng.randn(bh, sk, d).astype(np.float32) * qk_scale
    v = rng.randn(bh, sk, d).astype(np.float32)
    return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]


def _attn_within(got, want):
    """float32: largest abs error within 1e-5 of the largest output.
    bfloat16, each element: |got - want| <= 2**-7 |want| (one bf16 ulp of
    the value) + 1e-3 of the largest output."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    top = float(w.abs().max())
    if got.dtype == torch.float32:
        return float(err.max()) <= 1e-5 * top
    return bool((err <= 2.0 ** -7 * w.abs() + 1e-3 * top).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(1, 1, 1, 16), (2, 200, 200, 64),
                                        (3, 200, 100, 128), (2, 100, 300, 256),
                                        (2, 1, 257, 64), (2, 257, 1, 128),
                                        (1, 65, 129, 16), (2, 130, 70, 256),
                                        (1, 64, 64, 48), (1, 190, 190, 208)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("qk", [0.3, 1.5], ids=["qk0.3", "peaky"])
def test_flash_attention_kernel_matches_plain(dev, bh, sq, sk, d, dtype,
                                              causal, qk):
    """Against the plain version within ``_attn_within``'s limits; one
    launch a call; the same bytes in two runs. q and k at ``qk`` N(0, 1):
    at 1.5 the scores' std is 2.25, so the running max moves across key
    tiles and a missing rescale of the accumulator or the denominator
    shows."""
    rng = np.random.RandomState(bh + sq + 3 * sk + d)
    q, k, v = _attn_inputs(rng, bh, sq, sk, d, dtype, dev, qk_scale=qk)
    fn = flash_attention.flash_attention
    before = fn.launches
    got = fn(q, k, v, causal)
    assert fn.launches == before + 1
    again = fn(q, k, v, causal)
    assert fn.launches == before + 2
    want = ref.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    assert _attn_within(got, want)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(200, 200), (64, 130)])
@pytest.mark.parametrize("d", [128, 208])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_heads_stay_apart_at_a_ragged_sk(dev, sq, sk, d,
                                                          causal):
    """BH = 3 with head 1's K and V all inf: heads 0 and 2 equal, byte for
    byte, the kernel run on each head alone. A key tile past a ragged Sk
    must read zeros, not the next head's rows (inf there would make NaN)."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = _attn_inputs(rng, 3, sq, sk, d, torch.bfloat16, dev)
    k[1] = float("inf")
    v[1] = float("inf")
    fn = flash_attention.flash_attention
    got = fn(q, k, v, causal)
    for h in (0, 2):
        alone = fn(q[h:h + 1].contiguous(), k[h:h + 1].contiguous(),
                   v[h:h + 1].contiguous(), causal)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(alone).all())
        assert torch.equal(got[h:h + 1].view(torch.uint8),
                           alone.view(torch.uint8))


@pytest.mark.cuda
def test_flash_attention_wrapper_counts_launches_and_rejects_bad_operands(dev):
    rng = np.random.RandomState(11)
    q, k, v = _attn_inputs(rng, 2, 70, 70, 64, torch.bfloat16, dev)
    fn = flash_attention.flash_attention
    before = fn.launches
    out = torch.full((2, 70, 64), float("nan"), dtype=torch.bfloat16,
                     device=dev)
    assert fn(q, k, v, True, out) is out and not bool(out.isnan().any())
    got = ops.flash_attention(q, k, v, causal=False, bk=70)
    assert fn.launches == before + 2
    assert _attn_within(got, ref.flash_attention(q, k, v, False))
    with pytest.raises(ValueError, match="Sk % bk"):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="is on cpu"):
        fn(q, k.cpu(), v)
    with pytest.raises(ValueError, match="is on cpu"):
        fn(q, k, v, True, out.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="shape"):
        fn(q, k, v, True, out[:, :69])
    with pytest.raises(ValueError, match="head dim"):
        fn(q[..., :8].contiguous(), k[..., :8].contiguous(),
           v[..., :8].contiguous())
    with pytest.raises(ValueError, match="one dtype"):
        fn(q.float(), k, v)
    flat = torch.zeros(2 * 70 * 64 + 1, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fn(flat[1:].view(2, 70, 64), k, v)
    assert fn.launches == before + 2


@pytest.mark.cuda
def test_flash_attention_64_bit_offsets(dev):
    """BH = 131,100 heads of S = 128, D = 128 in bfloat16: BH * S * D =
    2.15e9 elements (4.3 GB a tensor), past 2**31. The last two heads and
    the first against the plain version on those heads alone."""
    bh, s, d = 131100, 128, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    out = flash_attention.flash_attention(q, k, v, True)
    for heads in (slice(bh - 2, bh), slice(0, 1)):
        want = ref.flash_attention(q[heads], k[heads], v[heads], True)
        assert _attn_within(out[heads], want)
    del q, k, v, out
    torch.cuda.empty_cache()


def _lossy_case(rng, n, k, t, sources, float_weights, dev):
    """A Lossy Counting stack [n, k] part filled (empty slots among full
    ones, some keys repeated in a row, ties of counts) and a batch over it:
    Zipf items with the sentinel 0xFFFFFFFF and ids near 2**32, rows -1
    and n, masked tuples, a row holding a third of the batch, the first
    source row also routed to and listed twice."""
    keys = rng.randint(0, 40, (n, k)).astype(np.int32)
    keys[rng.rand(n, k) < 0.3] = -1
    counts = rng.randint(0, 6, (n, k)).astype(np.float32)
    error = (counts * (rng.rand(n, k) < 0.3)).astype(np.float32)
    items = (rng.zipf(1.3, t) % 60).astype(np.int64)
    items[::23] = 0xFFFFFFFF
    items[7::31] = 0xFFFFFFF0
    rows = rng.randint(0, n, t).astype(np.int32)
    rows[::3] = n // 2
    rows[::11] = -1
    rows[5::13] = n
    if sources:
        rows[1::17] = sources[0]
    vals = (rng.randn(t) * 3 if float_weights
            else rng.randint(1, 5, t)).astype(np.float32)
    mask = rng.rand(t) > 0.1
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    src = (c(np.asarray(sources + sources[:1], np.int64)) if sources
           else None)
    state = (c(keys), c(counts), c(error))
    batch = (c(rows), c(items.astype(np.uint32).view(np.int32)), c(vals),
             c(mask), src)
    return state, batch


LOSSY_PATTERNS = ("reinsert", "evict_return", "all_miss_ties",
                  "special_weights", "sentinel_bursts")


def _lossy_pattern(rng, pattern, n, k, t, float_weights, dev):
    """A stack of n rows holding one table (distinct keys) and a batch that
    row 0 takes as a routed run and row n - 1 as a data-source row, or,
    for ``phase3``, one empty data-source row over chip_smoke's phase-3
    traffic (Zipf(1.1) over 65,536 ids, 10% unique ids, weights 1-4):

      reinsert         new items taken and hit again within 32 tuples
      evict_return     every count tied; evicted items come back within
                       a few tuples
      all_miss_ties    every tuple a new item on a full table of tied
                       counts, weight 1
      special_weights  counts and weights -0.0, +0.0, NaN and negative
      sentinel_bursts  empty slots and runs of 1-40 sentinel items
    """
    fresh = (1 << 20) + np.arange(4 * t)          # never in the table
    keys = (rng.permutation(1 << 19)[:k] + 7).astype(np.int64)
    counts = rng.randint(1, 4, k).astype(np.float32)
    error = np.zeros(k, np.float32)
    vals = (rng.rand(t) * 4 + 0.5 if float_weights
            else rng.randint(1, 5, t)).astype(np.float32)
    pool = np.concatenate([keys, fresh[-(k // 2 + 3):]])
    if pattern == "phase3":
        ids = rng.randint(0, 2**32 - 1, size=65536, dtype=np.int64)
        p = 1.0 / np.arange(1, 65537) ** 1.1
        items = ids[rng.choice(65536, size=t, p=p / p.sum())]
        unique = rng.rand(t) < 0.10
        items[unique] = rng.randint(0, 2**32 - 1, size=int(unique.sum()),
                                    dtype=np.int64)
        keys[:] = 0xFFFFFFFF
        counts[:] = 0.0
        vals = (rng.rand(t) * 3 + 1 if float_weights
                else rng.randint(1, 5, t)).astype(np.float32)
    elif pattern == "reinsert":
        items = rng.choice(keys, t)
        for g in range(0, t - 32, 32):
            for new in fresh[g // 8: g // 8 + 4]:
                i, j = rng.choice(32, 2, replace=False)
                items[g + i] = items[g + j] = new
    elif pattern == "evict_return":
        counts[:] = 2.0
        items = rng.choice(pool, t)
        back = np.nonzero(rng.rand(t) < 0.3)[0]
        back = back[back >= 8]
        items[back] = items[back - rng.randint(1, 8, back.size)]
    elif pattern == "all_miss_ties":
        counts[:] = 3.0
        items = fresh[:t].copy()
        vals[:] = 1.0
    elif pattern == "special_weights":
        specials = np.array([-0.0, 0.0, np.nan, -2.0, 1.5], np.float32)
        some = rng.rand(k) < 0.3
        counts[some] = rng.choice(specials, int(some.sum()))
        counts[::7] = -0.0
        counts[3::11] = np.nan
        items = rng.choice(pool, t)
        odd = rng.rand(t) < 0.2
        vals[odd] = rng.choice(specials, int(odd.sum()))
    else:                                        # sentinel_bursts
        keys[rng.rand(k) < 0.2] = 0xFFFFFFFF
        items = rng.choice(pool, t)
        for start in range(5, t - 40, 97):
            items[start:start + rng.randint(1, 41)] = 0xFFFFFFFF
    mask = rng.rand(t) > 0.05
    rows = np.zeros(t, np.int32) if pattern != "phase3" else \
        np.full(t, -1, np.int32)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table = keys.astype(np.uint32).view(np.int32)
    state = (c(np.tile(table, (n, 1))), c(np.tile(counts, (n, 1))),
             c(np.tile(error, (n, 1))))
    batch = (c(rows), c(items.astype(np.uint32).view(np.int32)), c(vals),
             c(mask), c(np.asarray([n - 1], np.int64)))
    return state, batch


# csrc/lossy_scan.cu's kGroupK and kBroadcastK, read back below
LOSSY_GROUP_K, LOSSY_BROADCAST_K = 1024, 128
_LOSSY_CASES = [
    (7, 20, 300, [], None), (7, 34, 300, [2], None),
    (5, 20, 2000, [0, 4], None), (3, 100, 1000, [1], None),
    (1, 4, 700, [0], None), (4099, 34, 6000, [4098], None),
    (4, 33, 1, [], None), (3, 300, 800, [0], None), (2, 1000, 1200, [1], None),
    (3, 2000, 900, [2], None), (3, 20000, 1500, [2], None),
    # each side of the hash index (k > LOSSY_BROADCAST_K) and of the group
    # walk (k <= LOSSY_GROUP_K)
    (3, LOSSY_BROADCAST_K, 900, [1], None),
    (3, LOSSY_BROADCAST_K + 1, 900, [1], None),
    (2, LOSSY_GROUP_K, 1200, [1], None),
    (2, LOSSY_GROUP_K + 1, 1200, [1], None),
    *[(2, k, 6000, [], pattern) for pattern in LOSSY_PATTERNS
      for k in (20, 100, LOSSY_BROADCAST_K, LOSSY_BROADCAST_K + 1, 1000,
                LOSSY_GROUP_K)],
    (1, 100, 65536, [], "phase3"), (1, 1000, 65536, [], "phase3")]


@pytest.mark.cuda
@pytest.mark.parametrize("float_weights", [False, True],
                         ids=["int_weights", "float_weights"])
@pytest.mark.parametrize("n,k,t,sources,pattern", _LOSSY_CASES)
def test_lossy_scan_matches_plain_byte_for_byte(dev, n, k, t, sources,
                                                pattern, float_weights):
    """The scan kernel against its plain version: tables compared key by
    key at k = 4 (fewer slots than lanes), 20, 33 and 34 (not multiples
    of 32), 100 and 128, through the hash index at 129, 300, 1,000 and
    1,024 (1 to 32 slots a lane), a step a tuple in shared memory at
    1,025 and 2,000 and in device memory at 20,000 (past a block's shared
    memory); runs of one tuple to a third of the batch; no source row,
    one routed to as well, two; the sentinel item; keys repeated in a row
    (``_lossy_case``: such a row is not indexed). Then ``_lossy_pattern``'s
    groups, each a routed run and a data-source walk of one table, and
    one data-source row over phase 3's traffic (T = 65,536). Keys, counts
    and error byte-equal to the plain version and across two
    kernel runs, one launch a call."""
    rng = np.random.RandomState(n + k + t)
    if pattern is None:
        state, batch = _lossy_case(rng, n, k, t, sources, float_weights,
                                   dev)
    else:
        state, batch = _lossy_pattern(rng, pattern, n, k, t, float_weights,
                                      dev)
    assert lossy_scan.group_k() == (LOSSY_GROUP_K, LOSSY_BROADCAST_K)
    if k == 20000:
        assert k > lossy_scan.max_shared_k()
    outs = []
    before = lossy_scan.lossy_scan_update.launches
    for _ in range(2):
        s = [x.clone() for x in state]
        lossy_scan.lossy_scan_update(*s, *batch)
        outs.append(s)
    assert lossy_scan.lossy_scan_update.launches == before + 2
    torch.cuda.synchronize()
    want = [x.clone() for x in state]
    ref.lossy_scan_update(*want, *batch)
    for a, b, w in zip(*outs, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    if pattern not in (None, "phase3"):     # the routed run, the source walk
        assert torch.equal(want[0][0].view(torch.int32),
                           want[0][-1].view(torch.int32))
    if t > 300:                       # a run longer than one load group
        assert lossy_scan.walks_of(batch[0], batch[3], n, batch[4])[1] > 32


@pytest.mark.cuda
def test_lossy_scan_rejects_bad_operands_and_skips_empty_batches(dev):
    state, batch = _lossy_case(np.random.RandomState(1), 5, 20, 64, [1],
                               False, dev)
    keys, counts, error = state
    rows, items, vals, mask, src = batch
    before = lossy_scan.lossy_scan_update.launches
    with pytest.raises(TypeError):
        lossy_scan.lossy_scan_update(keys, counts, error, rows, items, vals,
                                     mask.to(torch.int32), src)
    with pytest.raises(ValueError):
        lossy_scan.lossy_scan_update(keys, counts, error, rows[:-1], items,
                                     vals, mask, src)
    with pytest.raises(ValueError):
        lossy_scan.lossy_scan_update(keys, counts.cpu(), error, rows, items,
                                     vals, mask, src)
    empty = [x[:0] for x in batch[:4]]
    snapshot = [x.clone() for x in state]
    lossy_scan.lossy_scan_update(*state, *empty, src)
    assert lossy_scan.lossy_scan_update.launches == before
    assert all(torch.equal(a, b) for a, b in zip(state, snapshot))


def test_lossy_plain_matches_a_python_loop():
    """On the CPU: the plain scan the card tests compare against, held to
    a pure-Python loop over the batch (first hit, else first empty, else
    first least count; the sentinel hits empty slots), with the rows,
    sources and masks of the card cases, so a kernel is never held to a
    plain version that shares its mistake."""
    for n, k, t, sources in ((7, 20, 300, [2]), (3, 5, 400, [0, 2]),
                             (6, 34, 500, [])):
        rng = np.random.RandomState(k)
        state, batch = _lossy_case(rng, n, k, t, sources, True, "cpu")
        keys, counts, error = (x.numpy().copy() for x in state)
        rows, items, vals, mask, src = (
            None if x is None else x.numpy() for x in batch)
        src_set = set() if src is None else set(src.tolist())
        for r in range(n):
            for i in range(t):
                if not mask[i] or (r not in src_set and rows[i] != r):
                    continue
                kr, cr, er = keys[r], counts[r], error[r]
                x, v = items[i], vals[i]
                hits = np.nonzero(kr == x)[0]
                empties = np.nonzero(kr == -1)[0]
                if hits.size:
                    j = hits[0]
                    cr[j] = np.float32(cr[j] + v)
                elif empties.size:
                    j = empties[0]
                    kr[j], cr[j] = x, np.float32(np.float32(0) + v)
                else:
                    j = int(np.argmin(cr))
                    kr[j], er[j] = x, cr[j]
                    cr[j] = np.float32(cr[j] + v)
        got = [x.clone() for x in state]
        lossy_scan.lossy_scan_update(*got, *batch)
        for g, w in zip(got, (keys, counts, error)):
            assert g.numpy().tobytes() == w.tobytes()


RESERVOIR_PATTERNS = ("empty", "past_fill", "mixed", "hot")


def _reservoir_case(rng, n, s, t, sources, pattern, dev):
    """A reservoir-sampler stack [n, s] and a batch over it: rows -1 and
    n, masked tuples, item ids of 2**31 and above, float values, the first
    source row also routed to and listed twice. ``pattern`` sets the
    counts and the rows:

      empty      every row at n_seen 0 (the fill)
      past_fill  every row past its fill, some counts near 2**24 (where
                 float32(n + 1) rounds) and near 2**31 - 2t
      mixed      counts 0, below s and past it
      hot        mixed counts, and one row taking ~70% of the batch
    """
    top = 2**31 - 2 * t
    if pattern == "empty":
        n_seen = np.zeros(n, np.int64)
    elif pattern == "past_fill":
        n_seen = rng.randint(s, s + 5000, n)
        n_seen[::3] = rng.randint(2**24 - 300, 2**24 + 300, n_seen[::3].size)
        n_seen[1::5] = rng.randint(top - 1000, top + 1, n_seen[1::5].size)
    else:
        n_seen = rng.choice([0, 0, 1, max(s - 1, 0), s, 10 * s + 7, 2**24],
                            n)
    values = np.where(n_seen[:, None] > np.arange(s)[None, :],
                      rng.randn(n, s), 0).astype(np.float32)
    items = np.where(n_seen[:, None] > np.arange(s)[None, :],
                     rng.randint(0, 2**32, (n, s), dtype=np.int64), 0)
    in_items = rng.randint(0, 2**32, t, dtype=np.int64)
    in_items[::7] = rng.randint(2**31, 2**32, in_items[::7].size)
    rows = rng.randint(0, n, t).astype(np.int32)
    if pattern == "hot":
        rows[rng.rand(t) < 0.7] = n // 2
    rows[::11] = -1
    rows[5::13] = n
    if sources:
        rows[1::17] = sources[0]
    vals = (rng.randn(t) * 3).astype(np.float32)
    mask = rng.rand(t) > 0.1
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    src = (c(np.asarray(sources + sources[:1], np.int64)) if sources
           else None)
    state = (c(values), c(items.astype(np.uint32).view(np.int32)),
             c(n_seen.astype(np.int32)))
    batch = (c(rows), c(in_items.astype(np.uint32).view(np.int32)), c(vals),
             c(mask), src)
    return state, batch


RESERVOIR_SEED = 41
_RESERVOIR_CASES = [
    (7, 16, 300, [], "empty"), (7, 16, 300, [2], "past_fill"),
    (5, 64, 2000, [0, 4], "mixed"), (5, 64, 2000, [3], "hot"),
    (4, 1, 700, [1], "mixed"), (4, 1, 700, [], "hot"),
    (3, 33, 33, [], "empty"), (3, 33, 31, [0], "past_fill"),
    (1, 100, 5000, [0], "hot"), (2, 100, 1, [], "mixed"),
    (4099, 64, 6000, [4098, 7], "mixed"), (64, 64, 65536, [32], "hot"),
    *[(9, s, 4000, [2, 6], pattern) for pattern in RESERVOIR_PATTERNS
      for s in (1, 32, 64)]]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,t,sources,pattern", _RESERVOIR_CASES)
def test_reservoir_scan_matches_plain_byte_for_byte(dev, n, s, t, sources,
                                                    pattern):
    """The reservoir kernel against its plain version: S = 1 (every slot
    written by the last tuple that draws 0), 16, 32, 33, 64 and 100; one
    tuple to 65,536; runs of one tuple (within a warp's 32 positions) to
    ~70% of the batch (across many warps); no source row, one also routed
    to, two, one listed twice; counts from 0 through the fill, near 2**24
    and near 2**31 - 2T. Values, items and n_seen byte-equal to the plain
    version and across two kernel runs, one launch a call."""
    rng = np.random.RandomState(n + s + t)
    state, batch = _reservoir_case(rng, n, s, t, sources, pattern, dev)
    outs = []
    before = reservoir_scan.reservoir_scan_update.launches
    for _ in range(2):
        st = [x.clone() for x in state]
        reservoir_scan.reservoir_scan_update(*st, *batch,
                                             seed=RESERVOIR_SEED)
        outs.append(st)
    assert reservoir_scan.reservoir_scan_update.launches == before + 2
    torch.cuda.synchronize()
    want = [x.clone() for x in state]
    ref.reservoir_scan_update(*want, *batch, seed=RESERVOIR_SEED)
    for a, b, w in zip(*outs, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    if t > 1:                                         # some row took tuples
        assert not torch.equal(want[2], state[2])


@pytest.mark.cuda
def test_reservoir_scan_rejects_bad_operands_and_skips_empty_batches(dev):
    state, batch = _reservoir_case(np.random.RandomState(1), 5, 16, 64, [1],
                                   "mixed", dev)
    values, items, n_seen = state
    rows, in_items, vals, mask, src = batch
    update = reservoir_scan.reservoir_scan_update
    before = update.launches
    with pytest.raises(TypeError):
        update(values, items, n_seen, rows, in_items, vals,
               mask.to(torch.int32), src, seed=RESERVOIR_SEED)
    with pytest.raises(TypeError):
        update(values, items, n_seen.long(), rows, in_items, vals, mask, src,
               seed=RESERVOIR_SEED)
    with pytest.raises(ValueError):
        update(values, items, n_seen, rows[:-1], in_items, vals, mask, src,
               seed=RESERVOIR_SEED)
    with pytest.raises(ValueError):
        update(values, items.cpu(), n_seen, rows, in_items, vals, mask, src,
               seed=RESERVOIR_SEED)
    empty = [x[:0] for x in batch[:4]]
    snapshot = [x.clone() for x in state]
    update(*state, *empty, src, seed=RESERVOIR_SEED)
    assert update.launches == before
    assert all(torch.equal(a, b) for a, b in zip(state, snapshot))


@pytest.mark.cuda
def test_reservoir_scan_keeps_a_scratch_for_each_size(dev):
    """Two stacks of different sizes updated in turn, as an engine with
    two sampler kinds does in every batch: each size keeps its own zeroed
    scratch (the same buffer in every round), and every call stays
    byte-equal to the plain version."""
    cases = [_reservoir_case(np.random.RandomState(7 + s), 9, s, 3000, [2],
                             "mixed", dev) for s in (64, 16)]
    states = [[x.clone() for x in st] for st, _ in cases]
    wants = [[x.clone() for x in st] for st, _ in cases]
    held = reservoir_scan._SCRATCH.setdefault(
        (dev, build.stream(dev)), {})
    ptrs = []
    for _ in range(3):
        for st, want, (_, batch) in zip(states, wants, cases):
            reservoir_scan.reservoir_scan_update(*st, *batch,
                                                 seed=RESERVOIR_SEED)
            ref.reservoir_scan_update(*want, *batch, seed=RESERVOIR_SEED)
            for a, w in zip(st, want):
                assert torch.equal(a.view(torch.int32), w.view(torch.int32))
        ptrs.append([held[(9, s, 3000, 2)].data_ptr() for s in (64, 16)])
    assert ptrs[0] == ptrs[1] == ptrs[2]


def _reservoir_probe_case(rng, n, t, rows, dev, cut):
    """A routing table for a reservoir case's rows: an id a row in [0, n]
    (row n lies outside the stack) and filler ids routed past it, filled
    to the table's 0.7 load so that keys sit many slots from home, the
    rows in [0, n] given to the most displaced keys; the batch's
    stream-id halves (an id not in the table where the row is -1);
    n_probe the longest displacement + 1 - ``cut`` (cut 1: the most
    displaced keys, the first rows', resolve to -1)."""
    size = routing.next_pow2(max(64, int((n + 1) / 0.7) + 1))
    m = max(int(0.7 * size), n + 1)
    table = routing.RouteTable(size)
    table.insert_many(np.unique(rng.randint(0, 2**62, 2 * m,
                                            dtype=np.int64))[:m],
                      np.zeros(m, np.int32))
    held = np.nonzero(table.rows >= 0)[0]
    home = routing.slot_hash(*routing.split64(table.keys[held]), table.size)
    pop = table.keys[held[np.argsort(-((held - home) % table.size),
                                     kind="stable")]]
    table.insert_many(pop, np.arange(len(pop), dtype=np.int32))  # rows only
    rows = rows.cpu().numpy()
    sids = np.where(rows >= 0, pop[np.clip(rows, 0, n)],
                    (1 << 62) + rng.randint(0, 2**40, t))
    lo, hi = routing.split64(table.keys)
    slo, shi = routing.split64(sids)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ((c(lo.view(np.int32)), c(hi.view(np.int32)), c(table.rows)),
            (c(slo.view(np.int32)), c(shi.view(np.int32))),
            max(table.max_probe - cut, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [0, 1], ids=["all_found", "longest_cut"])
@pytest.mark.parametrize("n,s,t,sources,pattern", _RESERVOIR_CASES)
def test_reservoir_probe_scan_matches_plain_byte_for_byte(dev, n, s, t,
                                                          sources, pattern,
                                                          cut):
    """The fused entry (the probe in the kernel's first phase) against
    the plain probe plus the plain version, on every case above, over a
    table at 0.7 load with n_probe its longest displacement + 1 (every id
    found on its last step) or one less (the most displaced ids take no
    row); two runs byte-equal, one launch a call, and a rows-given call
    between them at the same sizes (the two share the stream's scratch)."""
    rng = np.random.RandomState(n + s + t + cut)
    state, batch = _reservoir_case(rng, n, s, t, sources, pattern, dev)
    rows, in_items, vals, mask, src = batch
    table, sids, n_probe = _reservoir_probe_case(rng, n, t, rows, dev, cut)
    plain_rows = probe.probe_rows(*table, *sids, n_probe=n_probe)
    found = bool((plain_rows == torch.where(rows >= 0, rows, -1)).all())
    assert found if not cut else (t < 32 or not found)   # cut: rows dropped
    outs = []
    fused = reservoir_scan.reservoir_probe_scan_update
    before = (fused.launches, reservoir_scan.reservoir_scan_update.launches)
    for _ in range(2):
        st = [x.clone() for x in state]
        fused(*st, *table, *sids, in_items, vals, mask, src,
              n_probe=n_probe, seed=RESERVOIR_SEED)
        outs.append(st)
        other = [x.clone() for x in state]
        reservoir_scan.reservoir_scan_update(*other, plain_rows, in_items,
                                             vals, mask, src,
                                             seed=RESERVOIR_SEED)
    assert (fused.launches, reservoir_scan.reservoir_scan_update.launches) \
        == (before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()
    want = [x.clone() for x in state]
    ref.reservoir_scan_update(*want, plain_rows, in_items, vals, mask, src,
                              seed=RESERVOIR_SEED)
    for a, b, o, w in zip(*outs, other, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
        assert torch.equal(o.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_reservoir_probe_scan_rejects_bad_operands_and_skips_empty_batches(
        dev):
    rng = np.random.RandomState(2)
    state, batch = _reservoir_case(rng, 5, 16, 64, [1], "mixed", dev)
    rows, in_items, vals, mask, src = batch
    table, sids, n_probe = _reservoir_probe_case(rng, 5, 64, rows, dev, 0)
    update = reservoir_scan.reservoir_probe_scan_update
    before = update.launches
    call = lambda st, tb, sd, *rest: update(*st, *tb, *sd, *rest, src,
                                            n_probe=n_probe,
                                            seed=RESERVOIR_SEED)
    with pytest.raises(TypeError):
        call(state, table, sids, in_items, vals, mask.to(torch.int32))
    with pytest.raises(TypeError):
        call(state, table, (sids[0].long(), sids[1]), in_items, vals, mask)
    with pytest.raises(ValueError):                  # size not a power of 2
        call(state, [x[:-1] for x in table], sids, in_items, vals, mask)
    with pytest.raises(ValueError):
        call(state, table, (sids[0][:-1], sids[1]), in_items, vals, mask)
    with pytest.raises(ValueError):
        call(state, (table[0].cpu(), *table[1:]), sids, in_items, vals, mask)
    with pytest.raises(ValueError):
        call((state[0][:, :-1], *state[1:]), table, sids, in_items, vals,
             mask)
    snapshot = [x.clone() for x in state]
    call(state, table, [x[:0] for x in sids], in_items[:0], vals[:0],
         mask[:0])
    assert update.launches == before
    assert all(torch.equal(a, b) for a, b in zip(state, snapshot))


def _reservoir_step(n, x, s, seed):
    """The reference's step in numpy uint32 / float32 scalars: (slot,
    write) of item x arriving at count n."""
    m = 0xFFFFFFFF
    h = ((n * 2654435761) & m) ^ int(x) ^ ((seed * 0x9E3779B9 + 1) & m)
    for shift, mult in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, 1)):
        h = ((h ^ (h >> shift)) * mult) & m
    u = np.float32(np.float32(np.uint32(h)) * np.float32(2.0 ** -32))
    j = int(np.float32(u * np.float32(n + 1)))
    if n < s:
        return n, True
    return j, j < s


def test_reservoir_plain_matches_a_python_loop():
    """On the CPU: the plain reservoir update the card tests compare
    against, held to a pure-Python loop of the reference's step in numpy
    scalars over the batch, with the rows, sources, masks and counts of
    the card cases, so a kernel is never held to a plain version that
    shares its mistake."""
    for n, s, t, sources, pattern in ((7, 16, 300, [2], "mixed"),
                                      (3, 1, 200, [0, 2], "past_fill"),
                                      (4, 33, 400, [], "hot")):
        rng = np.random.RandomState(s + t)
        state, batch = _reservoir_case(rng, n, s, t, sources, pattern,
                                       "cpu")
        values, items, n_seen = (x.numpy().copy() for x in state)
        rows, in_items, vals, mask, src = (
            None if x is None else x.numpy() for x in batch)
        src_set = set() if src is None else set(src.tolist())
        for r in range(n):
            for i in range(t):
                if not mask[i] or (r not in src_set and rows[i] != r):
                    continue
                slot, write = _reservoir_step(int(n_seen[r]),
                                              in_items[i].view(np.uint32),
                                              s, RESERVOIR_SEED)
                if write:
                    values[r, slot], items[r, slot] = vals[i], in_items[i]
                n_seen[r] += 1
        got = [x.clone() for x in state]
        reservoir_scan.reservoir_scan_update(*got, *batch,
                                             seed=RESERVOIR_SEED)
        for g, w in zip(got, (values, items, n_seen)):
            assert g.numpy().tobytes() == w.tobytes()


@pytest.mark.smoke
def test_plain_versions_match_a_serial_loop_at_edge_shapes():
    """On the CPU: the plain versions the card tests compare against,
    held to a loop over the batch at the edge shapes above (rows -1 and
    n, ragged widths, an empty batch), so a kernel is never held to a
    plain version that shares its mistake."""
    rng = np.random.RandomState(3)
    for n, b, t in ((5, 1, 77), (16, 200, 513), (9, 33, 0)):
        rows = rng.randint(-1, n + 1, t).astype(np.int32)
        vals = rng.randint(-4, 5, t).astype(np.float32)
        signs = np.where(rng.rand(t, b) > 0.5, 1.0, -1.0).astype(np.float32)
        state0 = rng.randint(-3, 4, (n, b)).astype(np.float32)
        want = state0.copy()
        for i in range(t):
            if 0 <= rows[i] < n:
                want[rows[i]] += vals[i] * signs[i]
        got = rhp_project.rhp_project_update(
            torch.from_numpy(state0.copy()), torch.from_numpy(rows),
            torch.from_numpy(vals), torch.from_numpy(signs))
        assert np.array_equal(got.numpy(), want)
        for m, k in ((64, 3), (16, 1)):
            idx = rng.randint(0, m, (t, k)).astype(np.int32)
            upd = rng.randint(0, 3, t).astype(np.int32)
            bits0 = (rng.rand(n, m) > 0.8).astype(np.int32)
            want = bits0.copy()
            for i in range(t):
                if 0 <= rows[i] < n and upd[i] > 0:
                    for p in idx[i]:
                        want[rows[i], p] = max(want[rows[i], p], upd[i])
            got = bitset_or.bitset_max_update(
                torch.from_numpy(bits0.copy()), torch.from_numpy(rows),
                torch.from_numpy(idx), torch.from_numpy(upd))
            assert np.array_equal(got.numpy(), want)
    # the sliding-DFT tick, one element at a time in float32
    for s, f in ((1, 1), (37, 3)):
        re = (rng.randn(s, f) * 4).astype(np.float32)
        im = (rng.randn(s, f) * 4).astype(np.float32)
        delta = rng.randn(s).astype(np.float32)
        mask = (rng.rand(s) > 0.5).astype(np.float32)
        twr, twi = rng.randn(2, f).astype(np.float32)
        want_re, want_im = re.copy(), im.copy()
        for i in range(s):
            for j in range(f):
                if mask[i] > 0:
                    r = np.float32(re[i, j] + delta[i])
                    want_re[i, j] = np.float32(r * twr[j]) - np.float32(
                        im[i, j] * twi[j])
                    want_im[i, j] = np.float32(r * twi[j]) + np.float32(
                        im[i, j] * twr[j])
        got = sliding_dft.sliding_dft_step(
            *(torch.from_numpy(a.copy())
              for a in (re, im, delta, mask, twr, twi)))
        assert np.array_equal(got[0].numpy(), want_re)
        assert np.array_equal(got[1].numpy(), want_im)


STICKY_PARAMS = {8: dict(support=0.2, eps=0.1, delta=0.1, seed=37),
                 288: dict(support=0.01, eps=0.002, delta=0.01, seed=37),
                 4096: dict(support=0.001, eps=0.0001, delta=0.01, seed=37)}
STICKY_PATTERNS = ("empty", "epochs", "full", "hot", "edges")


def _sticky_state(rng, n, cap, pattern):
    """A Sticky Sampling stack [n, cap] as numpy: ``empty`` at init; else
    counts a few tuples below the start of epochs 1-4 (a handful near the
    int32 top, where n_seen + 1 wraps), tables part filled (``full``:
    every slot) with keys repeated within a row and ids of 2**31 and
    above, empty slots holding counts, epochs as their counts ask but
    every seventh row two behind and every fifth one ahead."""
    keys = np.full((n, cap), -1, np.int64)
    counts = np.zeros((n, cap), np.float32)
    n_seen = np.zeros(n, np.int64)
    epoch = np.zeros(n, np.int64)
    if pattern == "empty":
        return keys, counts, n_seen, epoch
    starts = np.asarray(sticky.epoch_starts(16 * cap), np.int64)
    k = rng.randint(1, min(4, len(starts)) + 1, n)
    n_seen = starts[k - 1] - rng.randint(1, 40, n)
    if pattern == "full":
        n_seen = np.maximum(starts[k - 1] + rng.randint(-3000, 3000, n), 0)
    n_seen[4::23] = 2**31 - 1 - rng.randint(0, 30, n_seen[4::23].size)
    want = sticky.want_of(torch.from_numpy(n_seen), 16 * cap).numpy()
    epoch = want.copy()
    epoch[::7] = np.maximum(want[::7] - 2, 0)
    epoch[3::5] = want[3::5] + 1
    fill = rng.rand(n, cap) < (1.0 if pattern == "full" else 0.6)
    ids = rng.randint(0, 3 * cap, (n, cap))
    ids[:, ::9] = rng.randint(2**31, 2**32, ids[:, ::9].shape)
    keys = np.where(fill, ids, -1)
    counts = np.where(fill, rng.randint(1, 30, (n, cap)),
                      np.where(rng.rand(n, cap) < 0.1, 2, 0)
                      ).astype(np.float32)
    return keys, counts, n_seen, epoch


def _sticky_batch(rng, n, cap, t, sources, hot):
    """Zipf items among the tables' ids, the sentinel 0xFFFFFFFF and ids
    of 2**31 and above; rows -1 and n, masked tuples, the first source
    row also routed to; with ``hot`` a row taking ~70% of the batch."""
    items = (rng.zipf(1.3, t) % (3 * cap)).astype(np.int64)
    items[::19] = 0xFFFFFFFF
    items[5::29] = rng.randint(2**31, 2**32, items[5::29].size)
    rows = rng.randint(0, n, t).astype(np.int32)
    if hot:
        rows[rng.rand(t) < 0.7] = n // 2
    rows[::11] = -1
    rows[5::13] = n
    if sources:
        rows[1::17] = sources[0]
    return rows, items, rng.rand(t) > 0.1


def _sticky_edges(state, batches, cap):
    """The bumps masked steps take, built on purpose on rows 0-2 (no
    source), one tuple before epoch 1 at the end of their tuples: row 0's
    last tuple of batch 1 sits before the batch's last position (the next,
    masked, step bumps it); row 1's is batch 1's last tuple, and batch 2
    gives it none (batch 2's first step bumps it); row 2 takes no tuple of
    batch 1, and batch 2's last tuples after its own are all masked."""
    keys, counts, n_seen, epoch = state
    e1 = sticky.epoch_starts(16 * cap)[0]
    (r1, _, m1), (r2, _, m2) = batches
    t = len(r1)
    for rows in (r1, r2):
        rows[np.isin(rows, [0, 1, 2])] = -1
    for rows, mask, row, at in ((r1, m1, 0, [t // 8, t // 4, t // 2, t - 5]),
                                (r1, m1, 1, [t // 8 + 1, t // 4 + 1, t - 1]),
                                (r2, m2, 0, [1, t // 3 + 1]),
                                (r2, m2, 2, [2, t // 5 + 1, t - 4])):
        rows[at] = row
        mask[at] = True
    r2[t - 3:] = 2
    m2[t - 3:] = False
    for row, m in ((0, 4), (1, 3), (2, 3)):
        n_seen[row] = e1 - 1 - m
        epoch[row] = 0


# counts that n adds of 1.0 cannot take in closed form, or that take it at
# its edge (2**24 + 1 is no float32)
STICKY_ODD_COUNTS = (2.0**24 - 3, 2.0**24 - 2, 2.0**24 - 1, 2.0**24,
                     2.0**24 + 2, 0.5, 1e30, np.nan, np.inf, -np.inf, -0.0,
                     -3.0)
# the walk's hard cases: phase 3's traffic from empty tables and past an
# epoch; a table a bump empties and the walk fills again; stretches that
# end at an epoch start and that cross the int32 wrap; an item admitted
# twice in a group beside more admitters than empty slots; sentinel bursts;
# keys repeated in a row; the counts above in hit slots; per-stream rows
# (one item a row, Zipf-hot long runs) whose runs cross an epoch start
STICKY_HARD_PATTERNS = ("phase3", "phase3_past", "refill", "ends", "twice",
                        "sentinels", "repeats", "odd", "streams")


def _sticky_phase3_batch(rng, n, t):
    """chip_smoke phase 3's traffic: Zipf(1.1) stream ids over 65,536
    ids, 10% unrouted ids and 0.2% masked tuples, items the ids folded to
    32 bits (``routing.fold64``); a routed id's row is its index mod n."""
    pop = np.unique(rng.randint(0, 2**62, size=70000, dtype=np.int64))
    pop = pop[rng.permutation(len(pop))[:65536]]
    p = 1.0 / np.arange(1, 65537) ** 1.1
    idx = rng.choice(65536, size=t, p=p / p.sum())
    sids = pop[idx]
    unrouted = rng.rand(t) < 0.10
    sids[unrouted] = rng.randint(0, 2**62, size=int(unrouted.sum()),
                                 dtype=np.int64) | (1 << 62)
    rows = np.where(unrouted, -1, idx % n).astype(np.int32)
    items = routing.fold64(sids).astype(np.int64)
    return rows, items, rng.rand(t) >= 0.002


def _sticky_hard(rng, n, cap, t, sources, pattern, n_batches):
    """The state (numpy, as ``_sticky_state``) and batches of one of
    STICKY_HARD_PATTERNS; every row's table is built alike, so the routed
    walks meet each case as the source walks do."""
    starts = np.asarray(sticky.epoch_starts(16 * cap), np.int64)
    keys = np.full((n, cap), -1, np.int64)
    counts = np.zeros((n, cap), np.float32)
    n_seen = rng.randint(0, max(1, starts[0] - 2 * t - 2), n).astype(
        np.int64)
    epoch = np.zeros(n, np.int64)
    if pattern == "streams":            # a stream a row, item its id's
        ids = rng.randint(0, 2**62, n, dtype=np.int64)  # fold; an epoch
        p = 1.0 / np.arange(1, n + 1) ** 1.1            # start ~200 in
        batches = []
        for _ in range(n_batches):
            rows = rng.choice(n, size=t, p=p / p.sum()).astype(np.int32)
            items = routing.fold64(ids[rows]).astype(np.int64)
            rows[rng.rand(t) < 0.1] = -1
            batches.append((rows, items, rng.rand(t) >= 0.002))
        n_seen[:] = starts[0] - 200
        return (keys, counts, n_seen, epoch), batches
    if pattern.startswith("phase3"):
        batches = [_sticky_phase3_batch(rng, n, t) for _ in range(n_batches)]
        if pattern == "phase3_past":    # full, an epoch start half a walk on
            hot = np.unique(batches[0][1])
            keys = hot[rng.randint(0, len(hot), (n, cap))]
            counts = rng.randint(1, 30, (n, cap)).astype(np.float32)
            k = int(np.searchsorted(starts, starts[0] + t // 2))
            n_seen[:] = starts[k] - t // 2
            epoch[:] = sticky.want_of(torch.from_numpy(n_seen),
                                      16 * cap).numpy()
        return (keys, counts, n_seen, epoch), batches
    pool = np.unique(np.concatenate([
        rng.randint(0, 2**31, 3 * cap), rng.randint(2**31, 2**32 - 1, cap)]))
    pool = pool[rng.permutation(len(pool))]
    batches = []
    for _ in range(n_batches):
        items = pool[(rng.zipf(1.3, t) - 1) % len(pool)]
        rows = rng.randint(0, n, t).astype(np.int32)
        rows[::11] = -1
        mask = rng.rand(t) > 0.05
        if pattern == "twice":      # per 32 positions: one new item three
            g = np.arange(t) // 32  # times, four more once each
            new = 2**32 - 2 - 8 * g
            for at, off in ((3, 0), (9, 0), (17, 0), (5, 1), (11, 2),
                            (23, 3), (29, 4)):
                items[at::32] = new[at::32] - off
                mask[at::32] = True
        if pattern == "sentinels":
            items[(np.arange(t) % 64 >= 10) & (np.arange(t) % 64 < 50)] = \
                0xFFFFFFFF
        batches.append((rows, items, mask))
    head = np.concatenate([pool[:cap // 2], pool[rng.permutation(
        np.arange(cap // 2, len(pool)))]])[:cap]
    for r in range(n):
        keys[r] = head[rng.permutation(cap)]
    counts = rng.randint(5, 30, (n, cap)).astype(np.float32)
    if pattern == "refill":             # a bump near the walk's start
        counts[:] = 1.0
        n_seen[:] = starts[0] - 1 - t // 8
    elif pattern == "ends":             # src[0]: an epoch start a third in;
        n_seen[:] = starts[0] - 1 - t // 3      # src[1]: across the wrap
        n_seen[sources[1]] = 2**31 - 1 - t // 4
        epoch[sources[1]] = int(sticky.want_of(
            torch.tensor([2**31 - 1]), 16 * cap)[0])
    elif pattern == "twice":            # three empty slots a table
        for r in range(n):
            keys[r, rng.choice(cap, 3, replace=False)] = -1
    elif pattern == "sentinels":        # a third empty, some with counts
        keys[rng.rand(n, cap) < 0.3] = -1
        counts[(keys == -1) & (rng.rand(n, cap) < 0.5)] = 0.0
    elif pattern == "repeats":          # each key ~4 times: the first copy
        keys = pool[rng.randint(0, max(1, cap // 4), (n, cap))]  # at 1
        for r in range(n):
            _, first = np.unique(keys[r], return_index=True)
            counts[r, first] = 1.0
        keys[rng.rand(n, cap) < 0.1] = -1
        n_seen[:] = starts[0] - 1 - t // 4
    elif pattern == "odd":              # the hot keys' first slots
        for r in range(n):
            at = [int(np.flatnonzero(keys[r] == x)[0])
                  for x in pool[:len(STICKY_ODD_COUNTS)]]
            counts[r, at] = STICKY_ODD_COUNTS
        n_seen[:] = starts[0] - 1 - t // 2
    return (keys, counts, n_seen, epoch), batches


def _sticky_case(rng, n, cap, t, sources, pattern, dev, n_batches=2):
    """A Sticky Sampling stack and ``n_batches`` batches over it (the
    state and batch patterns above); ``edges`` adds the masked-step bumps
    (``_sticky_edges``); STICKY_HARD_PATTERNS build both
    (``_sticky_hard``). Returns (state (keys, counts, n_seen, epoch),
    [(rows, items, mask, src), ...]) on ``dev``."""
    if pattern in STICKY_HARD_PATTERNS:
        state, batches = _sticky_hard(rng, n, cap, t, sources, pattern,
                                      n_batches)
    else:
        state = _sticky_state(rng, n, cap, "epochs" if pattern in ("hot",
                                                                   "edges")
                              else pattern)
        batches = [_sticky_batch(rng, n, cap, t, sources, pattern == "hot")
                   for _ in range(n_batches)]
    if pattern == "edges":
        _sticky_edges(state, batches, cap)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    src = (c(np.asarray(sources + sources[:1], np.int64)) if sources
           else None)
    keys, counts, n_seen, epoch = state
    state = (c(keys.astype(np.uint32).view(np.int32)), c(counts),
             c(n_seen.astype(np.uint32).view(np.int32)),
             c(epoch.astype(np.int32)))
    return state, [(c(rows), c(items.astype(np.uint32).view(np.int32)),
                    c(mask), src) for rows, items, mask in batches]


_STICKY_CASES = [
    (9, cap, 3000, sources, pattern)
    for cap in (8, 288)
    for pattern, sources in (("empty", []), ("epochs", [4]), ("full", [2, 6]),
                             ("hot", [7]), ("edges", [8]))] + [
    (5, 4096, 6000, [3], "epochs"), (5, 4096, 6000, [], "full"),
    (6, 4096, 20000, [4], "edges"), (3, 8, 1, [], "epochs"),
    (4, 288, 33, [3], "edges"), (4099, 288, 8000, [4098, 7], "epochs"),
    (64, 8, 65536, [32], "hot")] + [
    (4, 288, 4096, [1, 2] if pattern == "ends" else [1], pattern)
    for pattern in STICKY_HARD_PATTERNS
    if not pattern.startswith("phase3") and pattern != "streams"] + [
    (64, 288, 8192, [0], "streams"), (64, 4096, 8192, [0], "streams"),
    (64, 8, 8192, [], "streams")] + [
    (4, cap, 65536, [1], pattern) for cap in (288, 4096)
    for pattern in ("phase3", "phase3_past")] + [
    (3, 288, 20, [1], "epochs"), (3, 4096, 100, [1], "epochs"),
    (5, 4096, 6000, [1, 2], "ends"), (5, 4096, 6000, [1], "odd")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,t,sources,pattern", _STICKY_CASES)
def test_sticky_scan_matches_plain_byte_for_byte(dev, n, cap, t, sources,
                                                 pattern):
    """The sticky-scan kernel (rows given) against its plain version over
    two batches: capacities 8, 288 and 4,096; one tuple to 65,536; a hot
    row; no source row, one also routed to, two, one listed twice; every
    state pattern, and the bumps masked steps take (``edges``); the walk's
    hard cases (STICKY_HARD_PATTERNS), phase 3's traffic at T = 65,536
    from empty and past an epoch among them, and source walks shorter than
    one warp's share of a chunk. Keys, counts, n_seen and epoch byte-equal
    to the plain version and across two kernel runs, one launch a call."""
    params = STICKY_PARAMS[cap]
    rng = np.random.RandomState(n + cap + t)
    state, batches = _sticky_case(rng, n, cap, t, sources, pattern, dev)
    update = sticky_scan.sticky_scan_update
    outs = [[x.clone() for x in state] for _ in range(2)]
    want = [x.clone() for x in state]
    before = update.launches_by_capacity[cap]
    for batch in batches:
        for st in outs:
            update(*st, *batch, **params)
        ref.sticky_scan_update(*want, *batch, **params)
        torch.cuda.synchronize()
        for a, b, w in zip(*outs, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    assert update.launches_by_capacity[cap] == before + 2 * len(batches)
    assert not torch.equal(want[1], state[1])
    if pattern == "edges":                       # (a), (b), (c) bumped
        assert want[3][:3].tolist() == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [0, 1], ids=["all_found", "longest_cut"])
@pytest.mark.parametrize("n,cap,t,sources,pattern", [
    (9, 8, 3000, [4], "epochs"), (9, 288, 3000, [8], "edges"),
    (9, 288, 3000, [2, 6], "full"), (5, 4096, 6000, [3], "hot"),
    (4, 288, 33, [3], "edges"), (4, 288, 65536, [1], "phase3"),
    (4, 288, 4096, [1], "odd")])
def test_sticky_probe_scan_matches_plain_byte_for_byte(dev, n, cap, t,
                                                       sources, pattern,
                                                       cut):
    """The fused entry (the probe in the kernel's key pass) against the
    plain probe plus the plain version over two batches, on a table at
    0.7 load with n_probe its longest displacement + 1 (every id found on
    its last step) or one less (the most displaced ids take no row); two
    runs byte-equal, one launch a call, and a rows-given call beside them
    at the same sizes."""
    params = STICKY_PARAMS[cap]
    rng = np.random.RandomState(n + cap + t + cut)
    state, batches = _sticky_case(rng, n, cap, t, sources, pattern, dev)
    fused = sticky_scan.sticky_probe_scan_update
    outs = [[x.clone() for x in state] for _ in range(2)]
    other = [x.clone() for x in state]
    want = [x.clone() for x in state]
    before = (fused.launches, sticky_scan.sticky_scan_update.launches)
    for rows, items, mask, src in batches:
        table, sids, n_probe = _reservoir_probe_case(rng, n, t, rows, dev,
                                                     cut)
        plain_rows = probe.probe_rows(*table, *sids, n_probe=n_probe)
        for st in outs:
            fused(*st, *table, *sids, items, mask, src, n_probe=n_probe,
                  **params)
        sticky_scan.sticky_scan_update(*other, plain_rows, items, mask, src,
                                       **params)
        ref.sticky_scan_update(*want, plain_rows, items, mask, src,
                               **params)
        torch.cuda.synchronize()
        for a, b, o, w in zip(*outs, other, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))
            assert torch.equal(o.view(torch.int32), w.view(torch.int32))
    assert (fused.launches, sticky_scan.sticky_scan_update.launches) == \
        (before[0] + 2 * len(batches), before[1] + len(batches))


@pytest.mark.cuda
def test_sticky_scan_rejects_bad_operands_and_skips_empty_batches(dev):
    """Both entries raise on a wrong dtype, shape, device or capacity and
    on a table of no power of two, and launch nothing on an empty batch
    (the reference's scan of no tuple takes no step)."""
    params = STICKY_PARAMS[8]
    rng = np.random.RandomState(1)
    state, batches = _sticky_case(rng, 5, 8, 64, [1], "epochs", dev, 1)
    rows, items, mask, src = batches[0]
    update = sticky_scan.sticky_scan_update
    fused = sticky_scan.sticky_probe_scan_update
    table, sids, n_probe = _reservoir_probe_case(rng, 5, 64, rows, dev, 0)
    before = (update.launches, fused.launches)
    keys, counts, n_seen, epoch = state
    for bad, err in (((keys, counts, n_seen, epoch.long()), TypeError),
                     ((keys, counts.cpu(), n_seen, epoch), ValueError),
                     ((keys[:, :-1], counts[:, :-1], n_seen, epoch),
                      ValueError)):
        with pytest.raises(err):
            update(*bad, rows, items, mask, src, **params)
        with pytest.raises(err):
            fused(*bad, *table, *sids, items, mask, src, n_probe=n_probe,
                  **params)
    with pytest.raises(TypeError):
        update(*state, rows, items, mask.to(torch.int32), src, **params)
    with pytest.raises(ValueError):
        update(*state, rows[:-1], items, mask, src, **params)
    with pytest.raises(ValueError):
        update(*state, rows, items, mask, src, **STICKY_PARAMS[288])
    with pytest.raises(ValueError):                  # size not a power of 2
        fused(*state, *[x[:-1] for x in table], *sids, items, mask, src,
              n_probe=n_probe, **params)
    snapshot = [x.clone() for x in state]
    update(*state, rows[:0], items[:0], mask[:0], src, **params)
    fused(*state, *table, *[x[:0] for x in sids], items[:0], mask[:0], src,
          n_probe=n_probe, **params)
    assert (update.launches, fused.launches) == before
    assert all(torch.equal(a, b) for a, b in zip(state, snapshot))


@pytest.mark.cuda
def test_sticky_tables_equal_the_float_functions(dev):
    """The kernel's own want_epoch (``sticky_scan.eval_tables``) at every
    count up to 2**20 and at each epoch start and its neighbours, and its
    geo at every hash within 2**12 of each power of two, equal the literal
    float32 functions on the CPU, for the three capacities."""
    h = np.unique(np.concatenate(
        [np.arange(max(0, 2**e - 4096), min(2**e + 4096, 2**32))
         for e in range(0, 33)]))
    want_geo = sticky.geo_of_hash(torch.from_numpy(h)).numpy()
    for cap in STICKY_PARAMS:
        t = 16 * cap
        want, geo = sticky_scan.eval_tables(
            cap, 1, 2**20, torch.from_numpy(h.astype(np.uint32).view(
                np.int32)).to(dev))
        n = torch.arange(1, 2**20 + 1)
        assert np.array_equal(want.cpu().numpy(),
                              sticky.want_epoch(n, t).numpy())
        assert geo.cpu().numpy().view(np.int32).tobytes() == \
            want_geo.view(np.int32).tobytes()
        for s in sticky.epoch_starts(t):
            got, _ = sticky_scan.eval_tables(cap, s - 2, 4,
                                             torch.zeros(1, dtype=torch.int32,
                                                         device=dev))
            ref_n = torch.arange(s - 2, s + 2)
            assert np.array_equal(got.cpu().numpy(),
                                  sticky.want_epoch(ref_n, t).numpy())


GK_PATTERNS = ("empty", "idle", "mixed", "hot", "nonfinite", "unsorted_idle",
               "inf_top", "wide", "huge")


def _gk_case(rng, n, m, t, sources, pattern, dev):
    """A GK stack [n, m] and a batch over it: rows -1 and n, masked
    tuples, values rounded to a few steps (ties) with -0.0 and 0.0 mixed
    in, the first source row also routed to and listed twice.
    ``pattern`` sets the state and the rows:

      empty      every row at n = 0, its values zero (a new stack)
      idle       counts in the thousands, each row's values sorted; 1% of
                 the tuples masked in, so nearly every row takes none
      mixed      counts 0 to 10**6, half the rows' values out of order
      hot        mixed, and one row taking ~70% of the batch
      nonfinite  mixed, with +inf, -inf and NaN tuples, and rows holding
                 +inf, -inf and NaN state values
      unsorted_idle  idle, but half the rows' values out of order, so
                 that rows without tuples take the sort
      inf_top    idle, each row's top eighth of its values +inf
      wide       mixed, counts below 10**6 and not whole (with hundreds
                 of tuples a row: heads past 256 entries, whose masked
                 tails' level sums need not rise)
      huge       mixed, counts near 2**30 (a tuple's weight below a
                 sum's rounding: midpoint ranks that need not rise)
    """
    counts = rng.randint(0, 10**6, n).astype(np.float32)
    values = (np.round(rng.randn(n, m) * 4) / 2).astype(np.float32)
    if pattern == "empty":
        counts[:] = 0
        values[:] = 0
    elif pattern in ("idle", "unsorted_idle", "inf_top"):
        counts = rng.randint(1000, 10000, n).astype(np.float32)
        values[::1 if pattern != "unsorted_idle" else 2].sort(axis=1)
        if pattern == "inf_top":
            values[:, -max(1, m // 8):] = np.inf
    else:
        values[::2].sort(axis=1)
        counts[::3] = 0
    if pattern == "wide":
        counts = (rng.rand(n) * 10**6).astype(np.float32)
    elif pattern == "huge":
        counts = (2.0**30 + rng.randint(0, 2**20, n)).astype(np.float32)
    if pattern == "nonfinite":
        values[1::4, :3] = np.inf
        values[2::4, -2:] = -np.inf
        values[3::5, m // 2] = np.nan
    vals = (np.round(rng.randn(t) * 4) / 2).astype(np.float32)
    vals[rng.rand(t) < 0.1] = -0.0
    if pattern == "nonfinite":
        for x, share in ((np.inf, 0.03), (-np.inf, 0.02), (np.nan, 0.02)):
            vals[rng.rand(t) < share] = x
    rows = rng.randint(0, n, t).astype(np.int32)
    if pattern == "hot":
        rows[rng.rand(t) < 0.7] = n // 2
    rows[::11] = -1
    rows[5::13] = n
    if sources:
        rows[1::17] = sources[0]
    mask = rng.rand(t) < (0.01 if "idle" in pattern or pattern == "inf_top"
                          else 0.9)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    src = (c(np.asarray(sources + sources[:1], np.int64)) if sources
           else None)
    return (c(values), c(counts)), (c(rows), c(vals), c(mask), src)


_GK_CASES = [
    (16, 0.5, 1, [], "empty"), (16, 0.5, 15, [3], "mixed"),
    (16, 0.5, 16, [], "nonfinite"), (16, 0.5, 17, [0, 9], "hot"),
    (8, 0.5, 4096, [2], "mixed"), (8, 0.5, 4096, [], "nonfinite"),
    (5, 0.5, 0, [1], "mixed"),
    (100, 0.01, 1000, [7], "idle"), (100, 0.01, 1000, [], "mixed"),
    (64, 0.01, 4096, [5, 63], "hot"), (64, 0.01, 4096, [6], "nonfinite"),
    (2000, 0.01, 65536, [1999], "idle"), (2000, 0.01, 65536, [3], "mixed"),
    (40, 0.004, 3000, [2], "hot"), (9, 4 / 4096, 2500, [4], "nonfinite"),
    (9, 4 / 4096, 700, [], "idle"),
    (6, 0.0005, 3000, [2], "nonfinite"), (5, 0.0005, 700, [], "idle"),
    (4, 0.0002, 257, [1], "hot"), (3, 0.0005, 0, [0], "mixed"),
    (16, 0.5, 300, [2], "unsorted_idle"), (16, 0.5, 300, [], "inf_top"),
    (100, 0.01, 1000, [7], "unsorted_idle"), (64, 0.004, 4096, [],
                                              "inf_top"),
    (9, 4 / 4096, 700, [4], "unsorted_idle"), (9, 4 / 4096, 0, [],
                                               "inf_top"),
    (2000, 0.01, 65536, [1999], "unsorted_idle"),
    (2000, 0.01, 65536, [], "inf_top"),
    (16, 0.01, 8192, [3], "wide"), (16, 0.01, 8192, [], "huge"),
    (16, 0.5, 4096, [2], "huge"), (16, 0.003, 8192, [5], "wide"),
    (16, 0.003, 8192, [], "huge"), (300, 0.003, 4096, [], "idle"),
    (300, 0.003, 4096, [7], "unsorted_idle")]


def _gk_run(update, state, *args, **kwargs):
    st = [x.clone() for x in state]
    update(*st, *args, **kwargs)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["rows", "fused"])
@pytest.mark.parametrize("n,eps,t,sources,pattern", _GK_CASES)
def test_gk_requantize_matches_plain_byte_for_byte(dev, n, eps, t, sources,
                                                   pattern, fused):
    """The requantize kernel, rows given or the probe fused (over a table
    at 0.7 load, every id found), against its plain version: m = 8, 400,
    1,000 and 4,096; T = 0 to 65,536; new, idle, out-of-order, hot and
    non-finite rows, idle rows out of order or with +inf tops (the warp
    pass and both checks' fallbacks), data-source rows, and states of
    8,000 and 20,000 values (past shared memory); every row's values and
    n byte-equal to the plain version and across two kernel runs, one
    launch a call."""
    m = gk.GKQuantiles(eps=eps).m
    rng = np.random.RandomState(n + m + t)
    state, (rows, vals, mask, src) = _gk_case(rng, n, m, t, sources,
                                              pattern, dev)
    if fused:
        table, sids, n_probe = _reservoir_probe_case(rng, n, t, rows, dev, 0)
        entry = gk_requantize.gk_probe_requantize_update
        args = (*table, *sids, vals, mask, src)
        kw = dict(n_probe=n_probe, m=m)
    else:
        entry = gk_requantize.gk_requantize_update
        args = (rows, vals, mask, src)
        kw = dict(m=m)
    before = entry.launches
    outs = [_gk_run(entry, state, *args, **kw) for _ in range(2)]
    assert entry.launches == before + 2
    torch.cuda.synchronize()
    want = _gk_run(ref.gk_requantize_update, state, rows, vals, mask, src,
                   m=m)
    for a, b, w in zip(*outs, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))


def _gk_paths(state, rows, vals, mask, src, m):
    """One rows-given call through the kernel's C interface, on a copy of
    the state: (values, n, the kernel's own counts of rows by path), read
    from the first words of its scratch (the comment on ``gk_requantize``
    in ``csrc/gk_requantize.cu``)."""
    values, counts = [x.clone() for x in state]
    scratch, order, nmask = gk_requantize._prepare(values, values.shape[0],
                                                   m, vals, mask)
    err = gk_requantize._lib().gk_requantize(
        values.data_ptr(), counts.data_ptr(), values.shape[0], m,
        rows.data_ptr(), vals.data_ptr(), mask.data_ptr(), vals.shape[0],
        order.data_ptr(), nmask.data_ptr(), build.ptr(src),
        0 if src is None else src.shape[0], scratch.data_ptr(),
        build.stream(values.device))
    build.check_launch(err, "gk_requantize")
    _, big, listed, warp_h, block_h, sorted_ = scratch[:6].tolist()
    return values, counts, {"warp": values.shape[0] - listed,
                            "warp halvings": warp_h,
                            "block": listed - big, "block halvings": block_h,
                            "sorted": sorted_, "big": big}


# (a _GK_CASES entry, the paths its rows must take on the card)
_GK_PATH_CASES = [
    ((300, 0.003, 4096, [], "idle"), ("warp", "warp halvings", "block",
                                      "block halvings")),
    ((300, 0.003, 4096, [7], "unsorted_idle"), ("warp", "warp halvings",
                                                "sorted", "big")),
    ((2000, 0.01, 65536, [1999], "unsorted_idle"), ("warp", "sorted",
                                                    "block halvings")),
    ((16, 0.01, 8192, [], "huge"), ("sorted", "block halvings")),
    ((16, 0.003, 8192, [5], "wide"), ("block halvings", "big"))]


@pytest.mark.cuda
@pytest.mark.parametrize("case,expect", _GK_PATH_CASES)
def test_gk_requantize_takes_each_path(dev, case, expect):
    """The kernel's own counts of its rows by path, on card-test cases
    whose rows call for each branch: a warp row and a block row whose
    midpoint ranks do not rise (the halvings; at m = 1,334, not a
    multiple of 16, an idle row's tail reads the head's level-0 sum),
    a block row whose state is sorted, and a big row. The call's bytes
    equal the plain version's, and the counts add up to the rows."""
    n, eps, t, sources, pattern = case
    assert case in _GK_CASES
    m = gk.GKQuantiles(eps=eps).m
    rng = np.random.RandomState(n + m + t)
    state, (rows, vals, mask, src) = _gk_case(rng, n, m, t, sources,
                                              pattern, dev)
    got_v, got_n, paths = _gk_paths(state, rows, vals, mask, src, m)
    want = _gk_run(ref.gk_requantize_update, state, rows, vals, mask, src,
                   m=m)
    assert torch.equal(got_v.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got_n.view(torch.int32), want[1].view(torch.int32))
    assert paths["warp"] + paths["block"] + paths["big"] == n
    assert paths["warp halvings"] <= paths["warp"]
    assert paths["block halvings"] <= paths["block"]
    missing = [k for k in expect if paths[k] == 0]
    assert not missing, (missing, paths)


@pytest.mark.cuda
def test_gk_requantize_rejects_bad_operands(dev):
    rng = np.random.RandomState(3)
    state, (rows, vals, mask, src) = _gk_case(rng, 5, 8, 64, [1], "mixed",
                                              dev)
    values, counts = state
    update = gk_requantize.gk_requantize_update
    fused = gk_requantize.gk_probe_requantize_update
    table, sids, n_probe = _reservoir_probe_case(rng, 5, 64, rows, dev, 0)
    before = (update.launches, fused.launches)
    for bad, err in (((values, counts.long()), TypeError),
                     ((values, counts.cpu()), ValueError),
                     ((values[:, :-1].contiguous(), counts), ValueError),
                     ((values.t().contiguous().t(), counts), ValueError)):
        with pytest.raises(err):
            update(*bad, rows, vals, mask, src, m=8)
        with pytest.raises(err):
            fused(*bad, *table, *sids, vals, mask, src, n_probe=n_probe, m=8)
    with pytest.raises(TypeError):
        update(values, counts, rows, vals, mask.to(torch.int32), src, m=8)
    with pytest.raises(ValueError):
        update(values, counts, rows[:-1], vals, mask, src, m=8)
    with pytest.raises(ValueError):                  # size not a power of 2
        fused(values, counts, *[x[:-1] for x in table], *sids, vals, mask,
              src, n_probe=n_probe, m=8)
    big_m = gk_requantize.MAX_M + 1
    big = torch.zeros((2, big_m), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):                  # m above the kernel's
        update(big, counts[:2], rows, vals, mask, None, m=big_m)
    assert (update.launches, fused.launches) == before


@pytest.mark.cuda
def test_gk_engine_state_past_shared_memory(dev):
    """A GK build at eps 0.0005 (m = 8,000, every row through the big-row
    pass) on the card's engine: per-stream and data-source rows over two
    ingests of continuous values, the stack byte-equal to the CPU
    engine's; a build at eps 3e-6 (m above the kernel's largest) is
    refused before anything is allocated, on the card only."""
    from repro_torch.service import SDE
    rng = np.random.RandomState(11)
    ids = [int(s) for s in rng.randint(0, 2**62, size=10, dtype=np.int64)]
    engines = (SDE(device=dev), SDE(device="cpu"))
    for e in engines:
        for sid, extra in (("gk", {"per_stream_of_source": True,
                                   "stream_ids": ids}), ("src-gk", {})):
            r = e.handle({"type": "build", "request_id": sid,
                          "synopsis_id": sid, "kind": "gk_quantiles",
                          "params": {"eps": 0.0005}, **extra})
            assert r.ok, r.error
    for _ in range(2):
        sids = np.asarray(ids, np.int64)[rng.randint(0, 10, 3000)]
        sids[::17] = -1
        vals = (rng.randn(3000) * 10).astype(np.float32)
        for e in engines:
            e.ingest(sids, vals)
    card, cpu = (next(iter(e.stacks.values())).state for e in engines)
    for k in ("values", "n"):
        assert torch.equal(card[k].cpu().view(torch.int32),
                           cpu[k].view(torch.int32))
    card_sde, cpu_sde = engines
    r = card_sde.handle({"type": "build", "request_id": "fine",
                         "synopsis_id": "fine", "kind": "gk_quantiles",
                         "params": {"eps": 3e-6}})
    assert not r.ok and "at most" in r.error
    assert "fine" not in card_sde.entries and len(card_sde.stacks) == 1


def test_gk_plain_matches_a_row_loop():
    """The plain stacked version (``ref.gk_requantize_update``: every row's
    head merged at once, its tail virtual) against a loop of the one-row
    update that builds each row's m + T entries (``core/gk.add_row``), on
    the CPU, over the card tests' patterns and three chained batches."""
    for n, eps, t, sources, pattern in _GK_CASES[:11]:
        m = gk.GKQuantiles(eps=eps).m
        rng = np.random.RandomState(n + m + t)
        state, (rows, vals, mask, src) = _gk_case(
            rng, n, m, t, sources, pattern, torch.device("cpu"))
        values, counts = [x.clone() for x in state]
        loop_v, loop_n = [x.clone() for x in state]
        listed = {int(r) for r in src.tolist()} if src is not None else set()
        routed = mask & ~torch.isin(rows, torch.tensor(sorted(listed),
                                                       dtype=torch.int32))
        for _ in range(3):
            ref.gk_requantize_update(values, counts, rows, vals, mask, src,
                                     m=m)
            for r in range(n):
                own = mask if r in listed else routed & (rows == r)
                loop_v[r], loop_n[r] = gk.add_row(loop_v[r], loop_n[r], vals,
                                                  own, m)
            assert torch.equal(values.view(torch.int32),
                               loop_v.view(torch.int32)), (n, m, t, pattern)
            assert torch.equal(counts.view(torch.int32),
                               loop_n.view(torch.int32))
