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


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "presorted"])
@pytest.mark.parametrize("r,block", [(4, 512), (8, 1 << 13)])
def test_path_blocks_match_jax(r, block, kind):
    # the flagship's block 512 at r = 4 and the composed path's 2^13 at
    # r = 8, on uniform, all-equal and presorted keys
    keys = {"uniform": _keys(2 * block, seed=54),
            "all_equal": np.full(2 * block, 0x5EEDBEEF, np.uint32),
            "presorted": np.arange(2 * block, dtype=np.uint32)}[kind]
    want = np.asarray(J.block_digit_histograms(jnp.asarray(keys), r, 0,
                                               block))
    got = T.block_digit_histograms(from_numpy(keys), r, 0, block)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("r", [1, 4, 5, 8, 9, 12])
@pytest.mark.parametrize("block", [128, 512, 1 << 13, 3 * 1024 * 9,
                                   1 << 15, 1 << 17])
def test_hist_plan_counts_every_key_once(block, r):
    # the plan's coverage of the keys, not the kernel: a copy of
    # csrc/histogram.cu's walk, replayed on numpy (counting group g of a
    # grid of `ctas` CTAs takes units g, g + groups, ...; unit u is part
    # u % parts of block u // parts, its thread t the 4-key vectors t,
    # t + group_threads, ... of the unit); chip_smoke.py holds the kernel
    # itself against the plain version on the card
    n = 4 * block
    plan = T.hist_plan(n, block, r)
    assert plan.mode == (T.LANE if r <= T.LANE_MAX_R else
                         T.WARP if r <= T.WARP_MAX_R else T.CTA)
    assert plan.unit % T.LANES == 0 and plan.unit <= T.UNIT_KEYS
    assert (plan.parts - 1) * plan.unit < block <= plan.parts * plan.unit
    assert plan.units == n // block * plan.parts
    keys = _keys(n, seed=r)
    digits = (keys >> np.uint32(r)) & np.uint32((1 << r) - 1)
    gpc = T.CTA_THREADS // plan.group_threads
    for ctas in (1, 3, 7):
        seen = np.zeros(n, np.int64)
        counts = np.zeros((n // block, 1 << r), np.int64)
        groups = ctas * gpc
        for g in range(groups):
            for u in range(g, plan.units, groups):
                blk, p = divmod(u, plan.parts)
                lo = blk * block + p * plan.unit
                length = min(plan.unit, block - p * plan.unit)
                for t in range(plan.group_threads):
                    vecs = np.arange(t, length // 4, plan.group_threads)
                    rows = (lo + 4 * vecs[:, None] + np.arange(4)).ravel()
                    seen[rows] += 1
                    np.add.at(counts[blk], digits[rows], 1)
        assert (seen == 1).all()
        np.testing.assert_array_equal(
            counts, to_numpy(T.block_digit_histograms(from_numpy(keys), r, 1,
                                                      block)))


def test_cuda_limits_match_hist_plan():
    # csrc/histogram.cu refuses any mode but the one hist_plan picks for
    # r, so its limits must be hist_plan's
    import re
    from pathlib import Path
    src = (Path(T.__file__).resolve().parent.parent / "csrc"
           / "histogram.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kLaneMaxR"] == T.LANE_MAX_R
    assert consts["kWarpMaxR"] == T.WARP_MAX_R
    assert consts["kMaxR"] == T.SHARED_MAX_R
    assert consts["kThreads"] == T.CTA_THREADS
    assert re.search(r"kLane = (\d+), kWarp = (\d+), kCta = (\d+)",
                     src).groups() == tuple(map(str, (T.LANE, T.WARP, T.CTA)))
    assert [T.hist_plan(1024, 1024, r).mode for r in range(13)] == (
        [T.LANE] * 5 + [T.WARP] * 4 + [T.CTA] * 4)
