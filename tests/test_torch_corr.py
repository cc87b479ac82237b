"""The StatStream correlation step in the port against the JAX package:
``ops.corr_matrix`` (its plain version on the CPU) against the reference's
``ops.corr_matrix``, which runs its Pallas kernel in interpret mode, and
against its oracle ``ref.pairwise_corr``; the DFT module's helpers
``corr_from_coeffs``, ``pairwise_corr`` and ``adjacent_bucket_mask``; and
the whole step over the coefficients the engines answer through
``SDE.handle``.

Tolerances: floats to ``rtol=1e-4, atol=1e-5``, the reference's own
kernel test's, because the two packages' CPU matrix products sum in
different orders (and the reference's Pallas kernel over padded lanes).
The candidate mask and the bucket coordinates must be byte-equal."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import dft as jdft
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.service import SDE as JaxSDE
from repro_torch import core as tcore
from repro_torch.core import dft as tdft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_corr, ref
from repro_torch.service import SDE as TorchSDE

RTOL, ATOL = 1e-4, 1e-5
FIG6 = dict(window=128, n_coeffs=8, threshold=0.9, grid_coeffs=2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.smoke
@pytest.mark.parametrize("shape", [(64, 16), (300, 16), (512, 40), (37, 3),
                                   (50, 8, 2), (1, 1)])
def test_corr_matrix_matches_jax(shape):
    """The reference's kernel test's three inputs (x ~ 0.1 N(0, 1)), a
    ragged one, an [N, F, 2] coefficient stack and a single stream."""
    rng = np.random.RandomState(shape[0])
    x = (rng.randn(*shape) * 0.1).astype(np.float32)
    before = pairwise_corr.pairwise_corr.launches
    got = tops.corr_matrix(_t(x))
    assert pairwise_corr.pairwise_corr.launches == before    # no card here
    _close(got, jops.corr_matrix(jnp.asarray(x)))
    flat = x.reshape(shape[0], -1)
    _close(got, jref.pairwise_corr(jnp.asarray(flat)))
    _close(ref.pairwise_corr(_t(flat)), jref.pairwise_corr(jnp.asarray(flat)))


def test_corr_matrix_casts_and_flattens_like_the_reference():
    """float64 and non-contiguous [N, F, 2] inputs become contiguous
    float32 [N, K], as the reference's ``reshape(...).astype``."""
    rng = np.random.RandomState(5)
    x = rng.randn(40, 2, 6)                                 # float64
    xt = _t(x).permute(0, 2, 1)                             # [40, 6, 2] view
    assert not xt.is_contiguous()
    got = tops.corr_matrix(xt)
    _close(got, jops.corr_matrix(jnp.asarray(np.transpose(x, (0, 2, 1)))))


def test_plain_pairwise_corr_matches_a_float64_loop():
    """The plain version every kernel is held to, against the formula
    summed pair by pair in float64, and ``out=`` filled in place."""
    rng = np.random.RandomState(11)
    x = (rng.randn(23, 7) * 0.3).astype(np.float32)
    xd = x.astype(np.float64)
    want = np.empty((23, 23))
    for i in range(23):
        for j in range(23):
            want[i, j] = 1.0 - (xd[i] @ xd[i] + xd[j] @ xd[j]
                                - 2.0 * (xd[i] @ xd[j]))
    out = torch.full((23, 23), np.nan)
    got = pairwise_corr.pairwise_corr(_t(x), out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pairwise_corr_wrapper_launches_only_on_the_card():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pairwise_corr.pairwise_corr(x)


@pytest.mark.parametrize("n,f", [(1, 1), (37, 3), (200, 8)])
def test_dft_correlation_helpers_match_jax(n, f):
    rng = np.random.RandomState(n + f)
    c = (rng.randn(n, f, 2) * 0.2).astype(np.float32)
    d = (rng.randn(n, f, 2) * 0.2).astype(np.float32)
    _close(tdft.corr_from_coeffs(_t(c), _t(d)),
           jdft.corr_from_coeffs(jnp.asarray(c), jnp.asarray(d)))
    # one stream against all: broadcast over the leading axis
    _close(tdft.corr_from_coeffs(_t(c[:1]), _t(d)),
           jdft.corr_from_coeffs(jnp.asarray(c[:1]), jnp.asarray(d)))
    got = tdft.pairwise_corr(_t(c))
    _close(got, jdft.pairwise_corr(jnp.asarray(c)))
    _close(tops.corr_matrix(_t(c)), jdft.pairwise_corr(jnp.asarray(c)))


@pytest.mark.parametrize("n,axes,cells", [(1, 4, 2), (64, 4, 2),
                                          (300, 6, 3), (129, 2, 7)])
def test_adjacent_bucket_mask_is_byte_equal(n, axes, cells):
    """Coordinates on the whole grid, its edge cells 0 and cells - 1
    included, and one pair per cell distance."""
    rng = np.random.RandomState(n + axes)
    coords = rng.randint(0, cells, (n, axes)).astype(np.int32)
    coords[::7] = 0
    coords[3::11] = cells - 1
    got = tdft.adjacent_bucket_mask(_t(coords))
    want = np.asarray(jdft.adjacent_bucket_mask(jnp.asarray(coords)))
    assert got.dtype == torch.bool and want.dtype == np.bool_
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy().shape == (n, n) and bool(got.diagonal().all())


def test_adjacent_bucket_mask_of_real_buckets():
    """The coords that ``DFT.bucket_of`` makes of coefficients on and past
    the grid's edges (clamped to cells 0 and cells - 1)."""
    kind = tcore.DFT(**FIG6)
    rng = np.random.RandomState(2)
    coeffs = (rng.randn(400, 8, 2) * 0.6).astype(np.float32)
    coords, _ = kind.bucket_of(_t(coeffs))
    c = coords.numpy()
    assert (c == 0).any() and (c == kind.grid_cells - 1).any()
    got = tdft.adjacent_bucket_mask(coords)
    want = np.asarray(jdft.adjacent_bucket_mask(jnp.asarray(c)))
    assert got.numpy().tobytes() == want.tobytes()
    assert 0 < int(got.sum()) < 400 * 400


def _engine_answers(sde, ids):
    r = sde.handle({"type": "query_many", "request_id": "qm", "queries": [
        {"synopsis_id": f"ts/{i}"} for i in ids]})
    assert r.ok
    assert all(a["ok"] for a in r.value)
    return (np.stack([np.asarray(a["value"]["coeffs"]) for a in r.value]),
            np.stack([np.asarray(a["value"]["coords"]) for a in r.value]))


def test_correlation_step_over_the_engines_coefficients():
    """A per-stream Figure-6 DFT through ``SDE.handle`` in both packages,
    a few ingests of correlated streams; the coefficients and coords the
    JAX engine answers go through both packages' correlation step, and
    the port's own answers through the port's."""
    rng = np.random.RandomState(4)
    n = 48
    ids = [int(s) for s in np.unique(rng.randint(0, 2**62, size=n,
                                                 dtype=np.int64))]
    build = {"type": "build", "request_id": "b", "synopsis_id": "ts",
             "kind": "dft", "params": FIG6, "per_stream_of_source": True,
             "stream_ids": ids}
    je, te = JaxSDE(), TorchSDE(device="cpu")
    assert je.handle(dict(build)).ok and te.handle(dict(build)).ok
    walk = np.cumsum(rng.randn(40, 4), axis=0)        # 4 latent walks
    for b in range(40):
        vals = (walk[b, np.arange(len(ids)) % 4]
                + 0.1 * rng.randn(len(ids))).astype(np.float32)
        req = {"type": "ingest", "request_id": f"i{b}", "stream_ids": ids,
               "values": [float(v) for v in vals]}
        assert je.handle(dict(req)).ok and te.handle(dict(req)).ok
    jc, jxy = _engine_answers(je, ids)
    tc, txy = _engine_answers(te, ids)
    assert jc.shape == (len(ids), 8, 2) and jc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    want = np.asarray(jops.corr_matrix(jnp.asarray(jc)))
    _close(tops.corr_matrix(_t(jc)), want)
    _close(tdft.pairwise_corr(_t(jc)), np.asarray(jdft.pairwise_corr(
        jnp.asarray(jc))))
    _close(tops.corr_matrix(_t(tc)), want)
    mask = tdft.adjacent_bucket_mask(_t(jxy))
    assert mask.numpy().tobytes() == np.asarray(
        jdft.adjacent_bucket_mask(jnp.asarray(jxy))).tobytes()
    # streams that follow one walk correlate: their estimates exceed the
    # others' on average
    same = (np.arange(len(ids))[:, None] % 4) == (np.arange(len(ids)) % 4)
    assert want[same].mean() > want[~same].mean()
