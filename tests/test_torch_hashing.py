"""The port's hashing (``repro_torch/core/hashing.py``), the Bloom and FM
positions built on it, and id splitting (``repro_torch/service/
routing.py``) against the JAX package's, byte for byte, on random ids and
on the edges 0, 2**32-1 and 2**63-1 -- and on items whose hash is 0 or a
power of two (``ctz32(0) = 32`` is clamped by FM)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.core import hashing as jh
from repro.service import routing as jrouting
from repro_torch import core as tcore
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


@pytest.mark.smoke
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


_M32 = 0xFFFFFFFF


def _items_hashing_to(seed, hashes):
    """Items x with ``hash_u32(x, seed) == h`` for each h: fmix32 is a
    bijection, so invert it and undo the seed's xor."""
    inv1, inv2 = pow(0x85EBCA6B, -1, 2**32), pow(0xC2B2AE35, -1, 2**32)
    salt = (seed * 0x9E3779B9 + 1) & _M32
    out = []
    for h in hashes:
        h ^= h >> 16
        h = (h * inv2) & _M32
        h ^= (h >> 13) ^ (h >> 26)
        h = (h * inv1) & _M32
        h ^= h >> 16
        out.append(h ^ salt)
    return np.asarray(out, np.uint32)


def test_items_hashing_to_inverts_the_hash():
    want = [0, 1, 2**31, 12345, 2**32 - 1]
    got = np.asarray(jh.hash_u32(jnp.asarray(_items_hashing_to(19, want)),
                                 np.uint32(19)))
    assert got.tolist() == want


@pytest.mark.parametrize("params", [{}, {"nmaps": 8, "bitmap_size": 16},
                                    {"nmaps": 1}, {"nmaps": 1024,
                                                   "bitmap_size": 4}],
                         ids=["default", "8x16", "one_map", "1024x4"])
def test_fm_which_pos_byte_equal(params):
    jk, tk = jcore.FMSketch(**params), tcore.FMSketch(**params)
    edges = _items_hashing_to(jk.seed, [0] + [1 << j for j in range(32)]
                              + [(1 << 31) | (1 << 5), _M32])
    x = np.concatenate([_ids32(5), edges])
    jw, jp = (np.asarray(a) for a in jk._which_pos(jnp.asarray(x)))
    tw, tp = tk._which_pos(_t(x))
    assert tw.dtype == tp.dtype == torch.int32
    assert np.array_equal(jw, tw.numpy()) and np.array_equal(jp, tp.numpy())
    n = len(edges)
    assert tp[-n].item() == tk.bitmap_size - 1          # hash 0: clamped
    assert tw[-n].item() == 0


def test_fm_rejects_nmaps_not_a_power_of_two():
    for kcls in (jcore.FMSketch, tcore.FMSketch):
        with pytest.raises(ValueError, match="power of two"):
            kcls(nmaps=3)


@pytest.mark.parametrize("params", [{"n_elements": 64, "fpr": 0.05},
                                    {"n_elements": 1024, "fpr": 0.01},
                                    {"n_elements": 3, "fpr": 0.5}])
def test_bloom_shape_and_positions_byte_equal(params):
    jk, tk = jcore.BloomFilter(**params), tcore.BloomFilter(**params)
    assert (jk.log2_bits, jk.n_bits, jk.k, jk.memory_bytes()) == \
        (tk.log2_bits, tk.n_bits, tk.k, tk.memory_bytes())
    seeds = [int(v) for v in jh.row_seeds(jk.seed, jk.k)]
    edges = np.concatenate([_items_hashing_to(sd, [0, 1, _M32])
                            for sd in seeds])
    x = np.concatenate([_ids32(6), edges])
    want = np.asarray(jh.bucket_hash(jnp.asarray(x), jk._seeds(),
                                      jk.log2_bits))
    got = tk._positions(_t(x))
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
