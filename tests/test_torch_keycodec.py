"""The port's key codecs, conversion and data generation
(lsdradixsort_tpu_torch/core) against the JAX package's codecs.

The same numpy input goes through lsdradixsort_tpu.core.keycodec and its
port; codes and decoded keys must agree bit for bit (integer outputs, no
tolerance). Mirrors tests/test_keycodec.py:32-80.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.core import keycodec as jk
from lsdradixsort_tpu_torch.core import keycodec as tk
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.core.datagen import (random_keys,
                                                 random_keys_bounded,
                                                 random_kv)

_SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0,
                      -1.0, 1e-38, -1e-38, 3.4e38, -3.4e38], np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _keys(rng, dtype, n=4096):
    if dtype == np.uint32:
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if dtype == np.int32:
        k = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
            np.int32)
        k[:4] = [np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max]
        return k
    k = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    k[:_SPECIALS.size] = _SPECIALS   # NaN, +-0.0, +-inf and extremes
    return k


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("desc", [False, True])
def test_encode_decode_match_jax(rng, dtype, desc):
    k = _keys(rng, dtype)
    code = tk.encode(from_numpy(k), desc)
    np.testing.assert_array_equal(to_numpy(code),
                                  np.asarray(jk.encode(jnp.asarray(k), desc)))
    back = tk.decode(code, from_numpy(k).dtype, desc)
    np.testing.assert_array_equal(_bits(to_numpy(back)), _bits(k))
    assert back.dtype == from_numpy(k).dtype


@pytest.mark.parametrize("desc", [False, True])
def test_encode_order_i32(rng, desc):
    k = _keys(rng, np.int32)
    c = to_numpy(tk.encode(from_numpy(k), desc))
    want = np.sort(k) if not desc else np.sort(k)[::-1]
    np.testing.assert_array_equal(k[np.argsort(c, kind="stable")], want)


def test_f32_total_order_specials():
    # IEEE total order: -NaN < -inf < -0.0 < +0.0 < +inf < +NaN
    k = np.array([np.float32(np.nan), -np.float32(np.nan), np.inf, -np.inf,
                  0.0, -0.0], dtype=np.float32)
    ranks = np.argsort(np.argsort(to_numpy(tk.encode(from_numpy(k)))))
    assert ranks[1] < ranks[3] < ranks[5] < ranks[4] < ranks[2] < ranks[0]


@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
@pytest.mark.parametrize("desc", [False, True])
def test_encode64_decode64_match_jax(rng, dtype, desc):
    hi = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    want = jk.encode64(jnp.asarray(hi), jnp.asarray(lo), dtype, desc)
    got = tk.encode64(from_numpy(hi), from_numpy(lo), dtype, desc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    back = tk.decode64(*got, dtype, desc)
    np.testing.assert_array_equal(to_numpy(back[0]), hi)
    np.testing.assert_array_equal(to_numpy(back[1]), lo)


def test_unsupported_dtypes_raise():
    with pytest.raises(TypeError):
        tk.encode(torch.zeros(4, dtype=torch.int16))
    with pytest.raises(TypeError):
        tk.decode64(torch.zeros(4, dtype=torch.uint32),
                    torch.zeros(4, dtype=torch.uint32), "int32")


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_convert_roundtrip_bits(rng, dtype):
    k = _keys(rng, dtype, 256)
    t = from_numpy(k)
    assert t.dtype == {np.uint32: torch.uint32, np.int32: torch.int32,
                       np.float32: torch.float32}[dtype]
    back = to_numpy(t)
    assert back.dtype == k.dtype
    np.testing.assert_array_equal(_bits(back), _bits(k))
    with pytest.raises(TypeError):
        from_numpy(np.zeros(4, np.int64))


def test_datagen_seeded_and_bounded():
    cpu = "cpu"                       # the generators default to the card
    a, b = random_keys(1000, 5, cpu), random_keys(1000, 5, cpu)
    assert a.dtype == torch.uint32 and torch.equal(a, b)
    assert not torch.equal(a, random_keys(1000, 6, cpu))
    kb = to_numpy(random_keys_bounded(5000, 7, 107, seed=1, device=cpu))
    assert kb.min() >= 7 and kb.max() < 107 and np.unique(kb).size == 100
    top = to_numpy(random_keys_bounded(5000, (1 << 32) - 3, 1 << 32,
                                       device=cpu))
    assert set(top.tolist()) == {(1 << 32) - 3, (1 << 32) - 2, (1 << 32) - 1}
    _, v = random_kv(10, device=cpu)
    np.testing.assert_array_equal(to_numpy(v), np.arange(10, dtype=np.uint32))
