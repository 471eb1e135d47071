"""The port's digit math and roofline (lsdradixsort_tpu_torch/core/digits.py,
core/roofline.py) against the JAX package's, on the same numpy input.
Digits and byte counts are integers and must agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.core import digits as JD
from lsdradixsort_tpu.core import roofline as JR
from lsdradixsort_tpu_torch.core import digits as TD
from lsdradixsort_tpu_torch.core import roofline as TR
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy


def _keys(n, seed=51):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]       # both sides of bit 31
    return k


@pytest.mark.parametrize("r,group", [(1, 0), (1, 31), (2, 5), (3, 10),
                                     (4, 7), (5, 6), (8, 3), (11, 2),
                                     (16, 1), (32, 0), (8, 4)])
def test_get_digit_matches_jax(r, group):
    # (3, 10) and (5, 6) cut the top digit short; (8, 4) shifts by 32
    k = _keys(4096)
    want = np.asarray(JD.get_digit(jnp.asarray(k), r, group))
    for dt in (np.uint32, np.int32):
        got = TD.get_digit(from_numpy(k.view(dt)), r, group)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(to_numpy(got), want)
    wide = torch.from_numpy(k.astype(np.int64))
    np.testing.assert_array_equal(TD.get_digit(wide, r, group).numpy(),
                                  want)
    if r * group < 32:
        np.testing.assert_array_equal(TD.get_digit_np(k, r, group),
                                      JD.get_digit_np(k, r, group))


def test_digit_groups_and_masks_match_jax():
    for r in range(1, 33):
        assert TD.num_digit_groups(r) == JD.num_digit_groups(r)
        for group in range(TD.num_digit_groups(r)):
            assert TD.low_bits_mask(r, group) == JD.low_bits_mask(r, group)
    for bad in (0, -1, 33):
        with pytest.raises(ValueError):
            TD.num_digit_groups(bad)
        with pytest.raises(ValueError):
            JD.num_digit_groups(bad)


def test_roofline_bytes_and_bounds_match_jax():
    for n, r, kb, vb in [(1 << 27, 8, 4, 0), (1 << 30, 4, 4, 4),
                         (12345, 3, 4, 8)]:
        assert TR.sort_pass_bytes(n, kb, vb) == JR.sort_pass_bytes(n, kb, vb)
        assert TR.sort_bytes(n, r, kb, vb) == JR.sort_bytes(n, r, kb, vb)
    t = TR.Roofline("H100", hbm_gbps=2000.0, spec_gbps=3350.0)
    j = JR.Roofline("H100", hbm_gbps=2000.0, spec_gbps=3350.0)
    assert t.fraction(1 << 30, 0.001) == j.fraction(1 << 30, 0.001)
    assert t.light_speed_s(1 << 30) == j.light_speed_s(1 << 30)
    cpu = TR.detect("cpu")
    assert cpu.device_kind == "cpu" and cpu.hbm_gbps == cpu.spec_gbps == 50.0
