"""The attention forward in the port against the JAX package: the port's
``ops.flash_attention`` (its plain version on the CPU) against the
reference's ``ops.flash_attention``, which runs its Pallas kernel in
interpret mode, and against the reference's oracle ``ref.flash_attention``,
on the same numpy inputs.

Tolerances are the reference's own kernel test's: the largest absolute
difference relative to the largest output, 1e-5 for float32 and 2e-2 for
bfloat16 (the two packages sum in different orders and round the
bfloat16 output on their own).

Where the reference's op pads keys (causal, Sq > Sk, Sk not a multiple of
its key block), its padded zero keys enter the softmax of the query rows
past Sk; the port follows the oracle there, as
``repro_torch/kernels/ops.py`` records.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, bh, sq, sk, d):
    """q and k at 0.3 N(0, 1), v at N(0, 1), as the reference's test."""
    q = rng.randn(bh, sq, d).astype(np.float32) * 0.3
    k = rng.randn(bh, sk, d).astype(np.float32) * 0.3
    v = rng.randn(bh, sk, d).astype(np.float32)
    return q, k, v


def _jax(arrays, dtype):
    return [jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


def _rel(got, want) -> float:
    a = (got.to(torch.float32).numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
    b = np.asarray(want, np.float32)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.smoke
@pytest.mark.parametrize("bh,s,d,bq,bk,causal,dtype", [
    (2, 256, 64, 128, 128, True, "float32"),
    (4, 128, 128, 64, 128, True, "float32"),
    (2, 200, 64, 128, 128, True, "float32"),      # padded seq
    (2, 256, 64, 128, 128, False, "float32"),
    (2, 256, 64, 128, 128, True, "bfloat16"),
])
def test_flash_attention_matches_jax(bh, s, d, bq, bk, causal, dtype):
    """The reference's kernel test's five cases, through both packages'
    ``ops.flash_attention`` and the reference's oracle. A CPU call
    launches no kernel."""
    arrays = _inputs(np.random.RandomState(s + d), bh, s, s, d)
    before = fa.flash_attention.launches
    got = tops.flash_attention(*_torch(arrays, dtype), causal=causal, bq=bq,
                               bk=bk)
    assert fa.flash_attention.launches == before == 0
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (bh, s, d)
    jq, jk, jv = _jax(arrays, dtype)
    assert _rel(got, jops.flash_attention(jq, jk, jv, causal=causal, bq=bq,
                                          bk=bk)) < TOL[dtype]
    assert _rel(got, jref.flash_attention(jq, jk, jv,
                                          causal=causal)) < TOL[dtype]


@pytest.mark.parametrize("sq,sk,causal", [(200, 100, True), (100, 200, True),
                                          (200, 100, False),
                                          (1, 37, True), (37, 1, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_and_unequal_lengths_follow_the_oracle(sq, sk, causal, dtype):
    """Sq != Sk both ways and single rows, through the wrapper (no block
    keywords): the port against the reference's oracle. The oracle is the
    ground truth where the reference's op pads keys (causal, Sq > Sk,
    ragged Sk): there the op departs from it, and the port does not."""
    arrays = _inputs(np.random.RandomState(sq + 3 * sk), 2, sq, sk, 64)
    got = fa.flash_attention(*_torch(arrays, dtype), causal)
    jq, jk, jv = _jax(arrays, dtype)
    assert _rel(got, jref.flash_attention(jq, jk, jv,
                                          causal=causal)) < TOL[dtype]
    if (sq, sk, causal, dtype) == (200, 100, True, "float32"):
        leak = _rel(jops.flash_attention(jq, jk, jv, causal=True),
                    jref.flash_attention(jq, jk, jv, causal=True))
        assert leak > 1e-2      # the reference's padded-key leak


def test_plain_version_matches_a_float64_softmax():
    """The plain version the card's kernel is held to, against a float64
    numpy softmax written out, causal from the top left, Sq != Sk."""
    rng = np.random.RandomState(5)
    for sq, sk, causal in ((7, 5, True), (5, 7, True), (6, 9, False)):
        q, k, v = _inputs(rng, 3, sq, sk, 16)
        s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / 4.0
        if causal:
            s = np.where(np.tri(sq, sk, dtype=bool), s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)
        got = ref.flash_attention(*_torch((q, k, v), "float32"), causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        out = torch.full((3, sq, 16), float("nan"))
        assert fa.flash_attention(*_torch((q, k, v), "float32"), causal,
                                  out) is out
        assert torch.equal(out, got)


def test_refusals():
    """The non-causal ragged-Sk call both packages refuse; the calls only
    the port refuses (a head dim off the multiples of 16 up to 256,
    mixed or unsupported dtypes, a wrong rank, mismatched shapes)."""
    q, k, v = _inputs(np.random.RandomState(0), 2, 128, 200, 64)
    with pytest.raises(AssertionError):
        jops.flash_attention(*_jax((q, k, v), "float32"), causal=False)
    tq, tk, tv = _torch((q, k, v), "float32")
    with pytest.raises(ValueError, match="Sk % bk"):
        tops.flash_attention(tq, tk, tv, causal=False)
    # a ragged Sk that is a multiple of bk passes in both
    assert tops.flash_attention(tq, tk, tv, causal=False, bk=40).shape == \
        (2, 128, 64)
    for d in (8, 24, 272):
        a = torch.zeros((1, 4, d))
        with pytest.raises(ValueError, match="head dim"):
            tops.flash_attention(a, a, a)
    with pytest.raises(ValueError, match="one dtype"):
        tops.flash_attention(tq, tk.to(torch.bfloat16), tv)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(tq.double(), tk.double(), tv.double())
    with pytest.raises(ValueError, match=r"\[BH, S, D\]"):
        tops.flash_attention(tq[0], tk[0], tv[0])
    with pytest.raises(ValueError, match=r"\[BH, S, D\]"):
        fa.flash_attention(tq[None], tk, tv)
    with pytest.raises(ValueError, match="k and v"):
        fa.flash_attention(tq, tk, tv[:, :199])
    with pytest.raises(ValueError, match=">= 1"):
        fa.flash_attention(tq[:, :0], tk, tv)
    assert fa.flash_attention.launches == 0
