"""The port's fill-forward (lsdradixsort_tpu_torch/kernels/fill_forward.py)
on CPU tensors — the plain PyTorch version — against the JAX package's
Pallas kernel in interpret mode (8-row tiles, as tests/test_kernels.py
runs it), on the same numpy input. All three outputs are defined on every
row, including the (0, 0, 0) before the first flagged row, and must agree
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import fill_forward as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import fill_forward as T

N = 5175          # not a tile multiple: the JAX kernel pads


def _flags(kind, rng):
    if kind == "none":
        return np.zeros(N, bool)
    if kind == "first_row":
        f = np.zeros(N, bool)
        f[0] = True
        return f
    if kind == "all":
        return np.ones(N, bool)
    return rng.random(N) < float(kind)


@pytest.mark.parametrize("kind", ["0.05", "0.5", "none", "first_row", "all"])
def test_fill_forward_last_matches_jax(kind):
    rng = np.random.default_rng(62)
    flag = _flags(kind, rng)
    key = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    val = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    want = J.fill_forward_last(jnp.asarray(flag), jnp.asarray(key),
                               jnp.asarray(val), tile_rows=8)
    got = T.fill_forward_last(torch.from_numpy(flag), from_numpy(key),
                              from_numpy(val), tile_rows=8)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.uint32 and g.shape == (N,)
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    if kind == "none":
        assert not to_numpy(got[2]).any() and not to_numpy(got[0]).any()


def test_u32_flags_equal_bool_flags():
    rng = np.random.default_rng(63)
    flag = rng.random(1000) < 0.1
    key = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    a = T.fill_forward_last(torch.from_numpy(flag), from_numpy(key),
                            from_numpy(key))
    b = T.fill_forward_last(from_numpy(flag.astype(np.uint32)),
                            from_numpy(key), from_numpy(key))
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_invalid_inputs_raise():
    f = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="uint32"):
        T.fill_forward_last(f, torch.zeros(8, dtype=torch.int64),
                            torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        T.fill_forward_last(f, from_numpy(np.zeros(7, np.uint32)),
                            from_numpy(np.zeros(7, np.uint32)))


def test_counters_count_plain_calls_on_cpu():
    launches = dict(T.LAUNCHES)
    plain = dict(T.PLAIN_CALLS)
    x = from_numpy(np.arange(64, dtype=np.uint32))
    T.fill_forward_last(torch.ones(64, dtype=torch.bool), x, x)
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["fill_forward_last"] == (
        plain["fill_forward_last"] + 1)
