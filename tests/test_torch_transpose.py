"""The port's transposes (lsdradixsort_tpu_torch/kernels/transpose.py) on
CPU tensors — the plain PyTorch version — against the JAX package's XLA
and Pallas (interpret mode) transposes, on the same numpy input. Bits
must agree exactly."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import transpose as T

# the JAX kernels package exports a function named `transpose`, which
# hides the module of that name: fetch the module
J = importlib.import_module("lsdradixsort_tpu.kernels.transpose")


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("shape,tile", [((128, 256), 128), ((256, 128), 64)])
def test_transposes_match_jax(dtype, shape, tile):
    rng = np.random.default_rng(59)
    a = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
        np.uint32).view(dtype)
    want = np.asarray(J.transpose_tiled(jnp.asarray(a), tile=tile))
    np.testing.assert_array_equal(want, np.asarray(J.transpose(
        jnp.asarray(a))))
    got = T.transpose_tiled(from_numpy(a), tile=tile)
    assert got.shape == shape[::-1] and got.dtype == from_numpy(a).dtype
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(T.transpose(from_numpy(a))), want)


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 16, 17])
@pytest.mark.parametrize("rows", [64, 37])
def test_narrow_transposes_match_jax(rows, cols):
    # the composed sort's (blocks, 2^r) histograms, and the narrow shapes
    # around them
    rng = np.random.default_rng(61)
    a = rng.integers(0, 2**32, (rows, cols), dtype=np.uint64).astype(
        np.uint32)
    got = T.transpose_any(from_numpy(a))
    assert got.shape == (cols, rows)
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(J.transpose(jnp.asarray(a))))


def test_cpu_calls_leave_the_c_entry_and_counters_alone():
    launches, plain = dict(T.LAUNCHES), dict(T.PLAIN_CALLS)
    for shape in ((64, 2), (64, 16), (64, 256)):
        T.transpose_any(torch.zeros(shape, dtype=torch.int32))
    assert T._transpose.cache_info().currsize == 0
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["transpose_tiled"] == plain["transpose_tiled"] + 3


def test_transpose_any_shape_and_invalid_inputs():
    # the composed sort transposes (blocks, 2^r) histograms of any shape
    a = torch.arange(6 * 2, dtype=torch.int32).view(6, 2)
    np.testing.assert_array_equal(T.transpose_any(a).numpy(), a.numpy().T)
    with pytest.raises(ValueError):
        T.transpose_tiled(torch.zeros((128, 96), dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        J.transpose_tiled(jnp.zeros((128, 96), jnp.int32), 64)
    with pytest.raises(ValueError):
        T.transpose_any(torch.zeros((4, 4), dtype=torch.int64))
    plain = T.PLAIN_CALLS["transpose_tiled"]
    T.transpose_tiled(torch.zeros((64, 64), dtype=torch.int32), 64)
    assert T.PLAIN_CALLS["transpose_tiled"] == plain + 1
    assert T.LAUNCHES["transpose_tiled"] == 0
