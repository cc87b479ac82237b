"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at edge shapes the main path does not reach: tiny and ragged
stacks (n = 1 spreads a block over bucket slices), depths 1 to 30 (deep
sketches stage fewer tuples per chunk in more shared memory), batches
below, at and above one 1024-tuple chunk, count-sketch signs, float
weights. Needs a card; run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hll_max, onehot_matmul, probe, ref
from repro_torch.service import routing

pytestmark = pytest.mark.cuda


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
