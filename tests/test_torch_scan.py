"""The port's exclusive scans (lsdradixsort_tpu_torch/kernels/scan.py) on
CPU tensors — the plain PyTorch versions — against the JAX package's
Pallas scans in interpret mode, on the same numpy input, with the
parameters of tests/test_kernels.py. Sums wrap mod 2^32 and must agree
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import scan as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import scan as T
from lsdradixsort_tpu_torch.kernels import transpose as TR


def _words(n, seed=54):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [128, 1 << 12, 1 << 16, 100_000, 131_072 + 640])
def test_exclusive_scan_matches_jax(n):
    a = _words(n)            # full-range words exercise the wraparound
    want = np.asarray(J.exclusive_scan(jnp.asarray(a), block_rows=8))
    got = T.exclusive_scan(from_numpy(a), block_rows=8)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(to_numpy(got), want)


def test_exclusive_scan_int32_matches_jax():
    rng = np.random.default_rng(55)
    a = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64).astype(
        np.int32)
    want = np.asarray(J.exclusive_scan(jnp.asarray(a), block_rows=8))
    got = T.exclusive_scan(from_numpy(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), want)
    assert want.dtype == np.int32


@pytest.mark.parametrize("n,block_rows", [(128 * 128, 8),
                                          (128 * 1000 + 17, 64)])
def test_exclusive_scan_hierarchical_matches_jax(n, block_rows):
    # the JAX kernel unrolls one tile scan per block of a grid step (up to
    # 256); 64-row blocks keep the ragged case at 16 of them, where 8-row
    # ones would unroll 126 and compile for minutes
    a = _words(n, seed=56)
    want = np.asarray(J.exclusive_scan_hierarchical(jnp.asarray(a),
                                                    block_rows=block_rows))
    got = T.exclusive_scan_hierarchical(from_numpy(a), block_rows=block_rows)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("block", [128, 512])
def test_block_prefix_sums_match_jax(block):
    a = _words(4 * block, seed=57)
    ws, wt = J.block_prefix_sums(jnp.asarray(a), block)
    gs, gt = T.block_prefix_sums(from_numpy(a), block)
    assert gs.shape == (4 * block,) and gt.shape == (4,)
    np.testing.assert_array_equal(to_numpy(gs), np.asarray(ws))
    np.testing.assert_array_equal(to_numpy(gt), np.asarray(wt))


@pytest.mark.parametrize("seg", [1, 2, 4, 8, 16, 256, 384, 4096, 8192])
def test_block_scans_any_segment(seg):
    # the composed sort scans histogram rows of 2^r words (no 128 rule)
    a = _words(24 * seg, seed=58).view(np.int32)
    scans, totals = T.block_scans(from_numpy(a), seg)
    v = a.astype(np.int64).reshape(-1, seg) & 0xFFFFFFFF
    want = ((np.cumsum(v, axis=1) - v) & 0xFFFFFFFF).astype(np.uint32)
    np.testing.assert_array_equal(to_numpy(scans).view(np.uint32),
                                  want.reshape(-1))
    np.testing.assert_array_equal(to_numpy(totals).view(np.uint32),
                                  (v.sum(axis=1) & 0xFFFFFFFF)
                                  .astype(np.uint32))


@pytest.fixture(scope="module", params=[1, 2, 4, 8])
def composed_step(request):
    """The JAX composed pass's scans of one (64, 2^r) histogram
    (lsdradixsort_tpu/ops/sort.py:523, :527): each block's counts of a
    2^13-key block, and the two expressions, computed once a shape."""
    r = request.param
    bins = 1 << r
    rng = np.random.default_rng(60 + r)
    digits = rng.integers(0, bins, (64, 1 << 13))
    hist = np.stack([np.bincount(d, minlength=bins) for d in digits]).astype(
        np.uint32)
    h = jnp.asarray(hist)
    gscan = J.exclusive_scan(h.T.reshape(-1).astype(jnp.uint32))
    lofs = jnp.cumsum(h, axis=1, dtype=jnp.uint32) - h
    return hist, np.asarray(lofs), np.asarray(gscan)


def test_composed_pass_scans_match_jax(composed_step):
    # the port's pass (ops/sort.py `_pass_destinations`): block_scans of
    # the histogram rows, the flat scan of the transposed histogram
    hist, want_lofs, want_gscan = composed_step
    bins = hist.shape[1]
    h = from_numpy(hist)
    lofs, totals = T.block_scans(h.view(-1), bins)
    np.testing.assert_array_equal(to_numpy(lofs).reshape(hist.shape),
                                  want_lofs)
    np.testing.assert_array_equal(to_numpy(totals), hist.sum(axis=1))
    gscan = T.exclusive_scan(TR.transpose_any(h).view(-1))
    np.testing.assert_array_equal(to_numpy(gscan), want_gscan)


def test_invalid_inputs_raise():
    x = from_numpy(np.zeros(3 * 128, np.uint32))
    for block in (256, 192):
        with pytest.raises(ValueError):
            T.block_prefix_sums(x, block)
        with pytest.raises(ValueError):
            J.block_prefix_sums(jnp.asarray(np.zeros(3 * 128, np.uint32)),
                                block)
    with pytest.raises(ValueError):
        T.block_scans(x, 7)
    with pytest.raises(ValueError):
        T.exclusive_scan(torch.zeros(8, dtype=torch.int64))


def test_counters_count_plain_calls_on_cpu():
    launches = dict(T.LAUNCHES)
    plain = dict(T.PLAIN_CALLS)
    x = from_numpy(_words(512))
    T.exclusive_scan(x)
    T.exclusive_scan_hierarchical(x)
    T.block_prefix_sums(x, 128)
    assert T.LAUNCHES == launches
    assert {k: T.PLAIN_CALLS[k] - plain[k] for k in plain} == dict.fromkeys(
        plain, 1)


def test_cpu_calls_leave_the_c_entries_and_counters_alone():
    # the cached C entries load the kernel library: a CPU tensor never
    # reaches them, and each call counts one plain call, no launch
    launches, plain = dict(T.LAUNCHES), dict(T.PLAIN_CALLS)
    x = from_numpy(_words(16 * 64))
    for seg in (2, 16, 256):
        scans, totals = T.block_scans(x, seg)
        assert scans.shape == (16 * 64,) and totals.shape == (16 * 64 // seg,)
    assert T._seg_scan.cache_info().currsize == 0
    assert T._lookback.cache_info().currsize == 0
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["block_prefix_sums"] == plain["block_prefix_sums"] + 3


# the hierarchical scan's grid on an H100 SXM: 132 SMs, one CTA of
# scan_rounds (128 KB of shared memory) each, a block of HIER_BLOCK words
# a CTA a round
H100_CTAS = 132
ROUND = H100_CTAS * T.HIER_BLOCK     # words a round of a full grid covers


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("n", [1, T.HIER_BLOCK - 1, T.HIER_BLOCK,
                               T.HIER_BLOCK + 1, ROUND - 1, ROUND,
                               ROUND + 1, 2 * T.HIER_BLOCK + 4 * 1001 + 3])
def test_exclusive_scan_hierarchical_edge_lengths(n, dtype):
    # the kernel's edges: one word, a block and a round of the grid plan
    # each side, a length that is no multiple of 4; full-range words wrap
    a = _words(n, seed=61).view(dtype)
    got = T.exclusive_scan_hierarchical(from_numpy(a))
    v = a.view(np.uint32).astype(np.uint64)
    want = ((np.cumsum(v) - v) & 0xFFFFFFFF).astype(np.uint32)
    assert got.dtype == from_numpy(a).dtype
    np.testing.assert_array_equal(to_numpy(got).view(np.uint32), want)
