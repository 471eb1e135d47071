"""The port's numpy golden models (lsdradixsort_tpu_torch/golden/) and native
host bindings (lsdradixsort_tpu_torch/native/) against the JAX package's, on
the same numpy inputs: outputs must be identical, values and dtypes."""
import numpy as np
import pytest

from lsdradixsort_tpu import golden as jax_golden
from lsdradixsort_tpu import native as jax_native
from lsdradixsort_tpu_torch import golden, native


def _keys(n, seed, hi=2**32):
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64
                                                ).astype(np.uint32)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


CASES = {
    "lsd_radix_sort_pass r=8 g=1": ("lsd_radix_sort_pass",
                                    lambda: (_keys(3000, 1), 8, 1)),
    "lsd_radix_sort_pass r=3 g=10": ("lsd_radix_sort_pass",
                                     lambda: (_keys(3000, 2, 1000), 3, 10)),
    "lsd_radix_sort r=8": ("lsd_radix_sort", lambda: (_keys(5000, 3), 8)),
    "lsd_radix_sort r=5": ("lsd_radix_sort", lambda: (_keys(5000, 4), 5)),
    "lsd_radix_sort_kv": ("lsd_radix_sort_kv",
                          lambda: (_keys(4000, 5, 50),
                                   np.arange(4000, dtype=np.uint32))),
    "prefix_sum u32": ("prefix_sum", lambda: (_keys(10000, 6),)),
    "prefix_sum i32": ("prefix_sum",
                       lambda: (_keys(777, 7).view(np.int32),)),
    "digit_histograms": ("digit_histograms",
                         lambda: (_keys(8192, 8), 4, 3, 1024)),
    "transpose": ("transpose",
                  lambda: (_keys(96 * 40, 9).reshape(96, 40),)),
    "filter_keys": ("filter_keys", lambda: (_keys(5000, 10), 1 << 30,
                                            3 << 30)),
    "group_by_sum": ("group_by_sum",
                     lambda: (_keys(6000, 11, 300), _keys(6000, 12))),
    "hash_join": ("hash_join",
                  lambda: (np.random.default_rng(13).permutation(
                      2000).astype(np.uint32), _keys(2000, 14),
                      _keys(6000, 15, 4000), _keys(6000, 16))),
    "hash_join_multi": ("hash_join_multi",
                        lambda: (_keys(2000, 17, 500), _keys(2000, 18),
                                 _keys(6000, 19, 1000), _keys(6000, 20))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_golden_matches_jax_golden(case):
    name, make = CASES[case]
    args = make()
    _same(getattr(golden, name)(*args), getattr(jax_golden, name)(*args))


@pytest.fixture(scope="module")
def keys():
    return native.fill_random_u32(1 << 16, seed=7)


def test_native_matches_jax_native(keys):
    assert native.available() == jax_native.available()
    _same(keys, jax_native.fill_random_u32(1 << 16, seed=7))
    _same(native.fill_random_u32(4096, 3, 10, 20),
          jax_native.fill_random_u32(4096, 3, 10, 20))
    other = keys.copy()
    other[123] ^= 1
    assert native.check_arrays(keys, other) == 123
    assert native.check_arrays(keys, keys) == -1
    bad = np.sort(keys)
    bad[100] = 0xFFFFFFFF
    assert native.check_sorted(bad) == jax_native.check_sorted(bad) == 101
    _same(native.exclusive_prefix_sum(keys),
          jax_native.exclusive_prefix_sum(keys))
    _same(native.block_histograms(keys, 1 << 12, 4, 5),
          jax_native.block_histograms(keys, 1 << 12, 4, 5))
    m = keys[:96 * 160].reshape(96, 160)
    _same(native.transpose(m), jax_native.transpose(m))
    _same(native.radix_sort_pass(keys, 8, 2),
          jax_native.radix_sort_pass(keys, 8, 2))


def test_native_sorts_match_np_sort(keys):
    _same(native.radix_sort(keys), np.sort(keys))
    _same(native.radix_sort(keys), jax_native.radix_sort(keys))
    k = native.fill_random_u32(1 << 14, seed=9, lo=0, hi=63)
    v = np.arange(k.size, dtype=np.uint32)
    perm = np.argsort(k, kind="stable")
    _same(native.radix_sort_kv(k, v), (k[perm], perm.astype(np.uint32)))
    _same(native.radix_sort_kv(k, v), jax_native.radix_sort_kv(k, v))
