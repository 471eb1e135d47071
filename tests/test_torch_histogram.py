"""The port's digit histograms (lsdradixsort_tpu_torch/kernels/histogram.py)
on CPU tensors — the plain PyTorch version — against the JAX package's
Pallas kernel in interpret mode, on the same numpy input, with the
parameters of tests/test_kernels.py. Counts are integers and must agree
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import histogram as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import histogram as T


def _keys(n, seed=52):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("r,group", [(1, 0), (2, 5), (4, 3), (8, 0), (8, 3)])
@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("cb", [8, 4])
def test_block_histograms_match_jax(r, group, block, cb):
    keys = _keys(4 * block)
    want = np.asarray(J.block_digit_histograms(jnp.asarray(keys), r, group,
                                               block, counter_bits=cb))
    got = T.block_digit_histograms(from_numpy(keys), r, group, block,
                                   counter_bits=cb)
    assert got.dtype == torch.uint32 and got.shape == (4, 1 << r)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("cb", [8, 4])
def test_all_equal_keys_count_exactly(cb):
    # one bin takes every key of a 2^16 block (the TPU kernel's counter
    # overflow guards, test_kernels.py:33-47)
    keys = np.zeros(512 * 128, dtype=np.uint32)
    want = np.asarray(J.block_digit_histograms(jnp.asarray(keys), 4, 0,
                                               512 * 128, counter_bits=cb))
    got = to_numpy(T.block_digit_histograms(from_numpy(keys), 4, 0,
                                            512 * 128, counter_bits=cb))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 512 * 128 and got.sum() == 512 * 128


@pytest.mark.parametrize("n", [1 << 15, 3 * (1 << 10)])
def test_whole_array_histogram_matches_jax(n):
    # 2^15 takes the 2^15 block, 3 * 2^10 the 2^10 one (_pick_block)
    keys = _keys(n, seed=53)
    want = np.asarray(J.digit_histogram(jnp.asarray(keys), 8, 2))
    got = T.digit_histogram(from_numpy(keys), 8, 2)
    assert got.shape == (256,) and got.dtype == torch.uint32
    np.testing.assert_array_equal(to_numpy(got), want)


def test_invalid_inputs_raise_like_jax():
    k = from_numpy(np.zeros(3 * 128, np.uint32))
    for block, cb in ((256, 8), (192, 8), (128, 2)):
        with pytest.raises(ValueError):
            T.block_digit_histograms(k, 4, 0, block, counter_bits=cb)
        with pytest.raises(ValueError):
            J.block_digit_histograms(jnp.asarray(np.zeros(3 * 128, np.uint32)),
                                     4, 0, block, counter_bits=cb)
    with pytest.raises(ValueError):
        T._pick_block(100)


def test_counters_count_plain_calls_on_cpu():
    launches = dict(T.LAUNCHES)
    plain = T.PLAIN_CALLS["block_digit_histograms"]
    k = from_numpy(_keys(1024))
    T.block_digit_histograms(k, 4, 1, 128)
    T.digit_histogram(k, 2, 0)
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["block_digit_histograms"] == plain + 2
