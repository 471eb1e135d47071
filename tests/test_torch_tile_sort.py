"""The port's tile sorts (lsdradixsort_tpu_torch/kernels/tile_sort.py) on
CPU tensors — their plain PyTorch versions — against the JAX package's
Pallas tile sorts in interpret mode, on the same numpy input.

Outputs are integers and must agree bit for bit, except where payloads
ride uncompared and the compared words tie: there the TPU network leaves
the order to the network, so those rows are compared as a multiset per
tie group (as tests/test_tile_sort.py:57-75 does).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import tile_sort as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import tile_sort as T


def _np(xs):
    return [np.asarray(x) for x in xs]


def _port(xs):
    return [to_numpy(x) for x in xs]


def _keys(kind, n, rng):
    return {
        "uniform": lambda: rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),
        "all_equal": lambda: np.full(n, 0xDEADBEEF, np.uint32),
        "presorted": lambda: np.arange(n, dtype=np.uint32),
        "reversed": lambda: np.arange(n, dtype=np.uint32)[::-1].copy(),
        "distinct97": lambda: rng.integers(0, 97, n, dtype=np.uint32),
        "extremes": lambda: rng.choice(
            np.array([0, 0xFFFFFFFF], np.uint32), n).astype(np.uint32),
    }[kind]()


KINDS = ["uniform", "all_equal", "presorted", "reversed", "distinct97",
         "extremes"]


@pytest.mark.parametrize("kind", KINDS)
def test_sort_tiles_matches_jax(kind):
    rng = np.random.default_rng(11)
    k = _keys(kind, 4 * 8 * 128, rng)
    want = np.asarray(J.sort_tiles(jnp.asarray(k), tile_rows=8))
    got = to_numpy(T.sort_tiles(from_numpy(k), tile_rows=8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "distinct97"])
def test_sort_tiles_kv_matches_jax(kind):
    rng = np.random.default_rng(12)
    n = 2 * 32 * 128
    k = _keys(kind, n, rng)
    v = np.arange(n, dtype=np.uint32)
    want = _np(J.sort_tiles_kv(jnp.asarray(k), jnp.asarray(v), tile_rows=32))
    got = _port(T.sort_tiles_kv(from_numpy(k), from_numpy(v), tile_rows=32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sort_tiles_kv_compares_val_signed():
    # the JAX kernel casts val to int32 with no bias (tile_sort.py:207): on
    # tied keys, vals >= 2^31 sort BEFORE smaller ones. The port keeps it.
    rng = np.random.default_rng(13)
    n = 4 * 8 * 128
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[:2] = [0x7FFFFFFF, 0x80000000]
    k[:2] = 1
    want = _np(J.sort_tiles_kv(jnp.asarray(k), jnp.asarray(v), tile_rows=8))
    got = _port(T.sort_tiles_kv(from_numpy(k), from_numpy(v), tile_rows=8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tile0 = got[1][:1024][got[0][:1024] == 1].tolist()
    assert tile0.index(0x80000000) < tile0.index(0x7FFFFFFF)


@pytest.mark.parametrize("kind", ["uniform", "distinct97", "extremes"])
def test_sort_tiles_multi_matches_jax(kind):
    # val0 = positions (unique): the order is fully determined
    rng = np.random.default_rng(14)
    n = 2 * 32 * 128
    k = _keys(kind, n, rng)
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, wv = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)],
                                tile_rows=32)
    gk, gv = T.sort_tiles_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)],
                                tile_rows=32)
    for g, w in zip(_port([gk, *gv]), _np([wk, *wv])):
        np.testing.assert_array_equal(g, w)


def test_sort_tiles_multi_one_payload_unsigned():
    # no riders: (key, val0) compared UNSIGNED (tile_sort.py:261)
    rng = np.random.default_rng(15)
    n = 4 * 8 * 128
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, (wv,) = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v)],
                                   tile_rows=8)
    gk, (gv,) = T.sort_tiles_multi(from_numpy(k), [from_numpy(v)],
                                   tile_rows=8)
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))


def test_sort_tiles_multi_tied_compare_pair_multiset():
    # compared (key, val0) ties with a rider: the compared streams are
    # determined; riders match as a multiset per tie group per tile
    rng = np.random.default_rng(5)
    n, tile = 2 * 32 * 128, 32 * 128
    k = rng.integers(0, 4, n, dtype=np.uint32)
    v0 = rng.integers(0, 2, n, dtype=np.uint32)
    v1 = np.arange(n, dtype=np.uint32)
    wk, wv = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)],
                                tile_rows=32)
    wk, (w0, w1) = np.asarray(wk), _np(wv)
    gk, gv = T.sort_tiles_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)], tile_rows=32)
    g0, g1 = _port(gv)
    np.testing.assert_array_equal(to_numpy(gk), wk)
    np.testing.assert_array_equal(g0, w0)
    for t in range(n // tile):
        s = slice(t * tile, (t + 1) * tile)
        got = collections.Counter(zip(wk[s].tolist(), g0[s].tolist(),
                                      g1[s].tolist()))
        want = collections.Counter(zip(wk[s].tolist(), w0[s].tolist(),
                                       w1[s].tolist()))
        assert got == want
    # the port orders riders stably within a tie group
    for t in range(n // tile):
        s = slice(t * tile, (t + 1) * tile)
        order = np.lexsort((v0[s], k[s]))
        np.testing.assert_array_equal(g1[s], v1[s][order])


def test_cpu_wrappers_run_plain_versions_only():
    k = from_numpy(np.arange(1024, dtype=np.uint32)[::-1].copy())
    launches = dict(T.LAUNCHES)
    plain = dict(T.PLAIN_CALLS)
    T.sort_tiles(k, tile_rows=8)
    T.sort_tiles_kv(k, k, tile_rows=8)
    T.sort_tiles_multi(k, [k, k], tile_rows=8)
    assert T.LAUNCHES == launches
    assert {n: T.PLAIN_CALLS[n] - plain[n] for n in plain} == {
        "sort_tiles": 1, "sort_tiles_kv": 1, "sort_tiles_multi": 1}


def test_invalid_inputs_raise():
    k = torch.zeros(1000, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        T.sort_tiles(k, tile_rows=8)                 # n % tile != 0
    k = torch.zeros(1024, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        T.sort_tiles(k, tile_rows=3)                 # not a power of 2
    with pytest.raises(ValueError):
        T.sort_tiles(k.view(torch.int32), tile_rows=8)   # not uint32
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [k, k], tile_rows=8, ncmp=4)
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [k], tile_rows=8, ncmp=3)  # 2 streams
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [], tile_rows=8, ncmp=2)
