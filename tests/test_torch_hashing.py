"""The port's hashing (``repro_torch/core/hashing.py``) and id splitting
(``repro_torch/service/routing.py``) against the JAX package's, byte for
byte, on random ids and on the edges 0, 2**32-1 and 2**63-1."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.service import routing as jrouting
from repro_torch.core import hashing as th
from repro_torch.service import routing as trouting

_EDGES64 = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                       2**63 - 1], np.int64)


def _ids32(seed=0, n=2000):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([x, np.asarray([0, 1, 2**31, 2**32 - 1],
                                         np.uint32)])


def _ids64(seed=1, n=2000):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2**63 - 1, size=n, dtype=np.int64)
    return np.concatenate([x, _EDGES64])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_mix32_and_hash_u32_byte_equal():
    x = _ids32()
    assert np.array_equal(np.asarray(jh.mix32(jnp.asarray(x))),
                          _u32(th.mix32(_t(x))))
    for seed in (0, 1, 11, 2**31 - 2, 2**32 - 1):
        want = np.asarray(jh.hash_u32(jnp.asarray(x), np.uint32(seed)))
        assert np.array_equal(want, _u32(th.hash_u32(_t(x), seed))), seed


def test_int32_bit_patterns_hash_like_uint32():
    x = _ids32()
    as_i32 = torch.from_numpy(x.view(np.int32).copy())
    assert torch.equal(th.mix32(as_i32), th.mix32(_t(x)))


def test_row_seeds_equal():
    for base, rows in ((7, 5), (11, 1), (3, 12)):
        assert np.array_equal(jh.row_seeds(base, rows),
                              th.row_seeds(base, rows))


@pytest.mark.parametrize("log2_width", [1, 6, 11, 16])
def test_bucket_hash_byte_equal(log2_width):
    x = _ids32(2)
    seeds = jh.row_seeds(7, 5)
    want = np.asarray(jh.bucket_hash(jnp.asarray(x), jnp.asarray(seeds),
                                      log2_width))
    got = th.bucket_hash(_t(x), th.as_u32(seeds), log2_width)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_sign_hash_and_uniform01_byte_equal():
    x = _ids32(3)
    seeds = jh.row_seeds(5, 4)
    want = np.asarray(jh.sign_hash(jnp.asarray(x), jnp.asarray(seeds)))
    got = th.sign_hash(_t(x), th.as_u32(seeds)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    want = np.asarray(jh.uniform01(jnp.asarray(x), np.uint32(9)))
    got = th.uniform01(_t(x), 9).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_clz32_ctz32_equal():
    x = _ids32(4)
    powers = np.asarray([1 << k for k in range(32)], np.uint32)
    x = np.concatenate([x, powers, powers - 1, powers + 1])
    for jf, tf in ((jh.clz32, th.clz32), (jh.ctz32, th.ctz32)):
        want = np.asarray(jf(jnp.asarray(x)))
        got = tf(_t(x))
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), jf.__name__


def test_split64_fold64_equal():
    s = _ids64()
    for a, b in zip(jrouting.split64(s), trouting.split64(s)):
        assert np.array_equal(a, b)
    assert np.array_equal(jrouting.fold64(s), trouting.fold64(s))
