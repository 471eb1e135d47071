"""Sequential numpy golden models — the correctness oracles.

The port's own copy of lsdradixsort_tpu/golden/oracles.py (whose digit
math imports jax.numpy): the same functions, with the digits from the
port's core/digits.py. The port's bench runner verifies against them.

These mirror the reference's CPU implementations, which serve both as the
timing baseline and as the element-by-element verification oracle for every
device kernel (reference test discipline: CheckArrays, Utils.cpp:62-68).

  lsd_radix_sort_pass / lsd_radix_sort : LSDRadixSort.cu:25-69
  prefix_sum (exclusive)               : LSDRadixSort.cu:128-139
  digit_histograms (per-block)         : LSDRadixSort.cu:643-658
  transpose                            : LSDRadixSort.cu:483-494

filter/aggregate/join are north-star extensions with no reference
counterpart; their oracles are straightforward numpy.

All functions are intentionally simple and allocation-happy — clarity over
speed. The fast CPU baseline lives in native/ (C++).
"""
from __future__ import annotations

import numpy as np

from lsdradixsort_tpu_torch.core.digits import get_digit_np, num_digit_groups


# ---------------------------------------------------------------------------
# Sort family
# ---------------------------------------------------------------------------

def lsd_radix_sort_pass(keys: np.ndarray, r: int, group: int) -> np.ndarray:
    """One stable counting-sort pass on the `group`-th r-bit digit.

    Mirrors LSDRadixSortPass (LSDRadixSort.cu:25-54): histogram, inclusive
    scan, reverse-order stable permute.
    """
    digits = get_digit_np(keys, r, group)
    bins = 1 << r
    hist = np.bincount(digits, minlength=bins)
    # exclusive offsets per digit
    offsets = np.zeros(bins, dtype=np.int64)
    np.cumsum(hist[:-1], out=offsets[1:])
    out = np.empty_like(keys)
    # forward stable permute (the reference walks backward with decrements,
    # cu:44-50 — same resulting order)
    ranks = offsets[digits] + _rank_within_digit(digits, bins)
    out[ranks] = keys
    return out


def _rank_within_digit(digits: np.ndarray, bins: int) -> np.ndarray:
    """Stable rank of each element among equal digits (vectorized)."""
    order = np.argsort(digits, kind="stable")
    ranks_sorted = np.arange(digits.size, dtype=np.int64)
    start_of_digit = np.zeros(bins, dtype=np.int64)
    hist = np.bincount(digits, minlength=bins)
    np.cumsum(hist[:-1], out=start_of_digit[1:])
    ranks_sorted -= start_of_digit[digits[order]]
    ranks = np.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    return ranks


def lsd_radix_sort(keys: np.ndarray, r: int = 8) -> np.ndarray:
    """Full LSD radix sort of uint32 keys (LSDRadixSort.cu:62-69)."""
    keys = np.asarray(keys, dtype=np.uint32)
    for group in range(num_digit_groups(r)):
        keys = lsd_radix_sort_pass(keys, r, group)
    return keys


def lsd_radix_sort_kv(keys: np.ndarray, values: np.ndarray, r: int = 8):
    """Stable key-value sort (north-star extension of cu:62-69)."""
    keys = np.asarray(keys, dtype=np.uint32)
    order = np.argsort(keys, kind="stable")
    return keys[order], np.asarray(values)[order]


# ---------------------------------------------------------------------------
# Scan
# ---------------------------------------------------------------------------

def prefix_sum(a: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum (PrefixSum, LSDRadixSort.cu:128-139).

    Matches the reference's uint32 wraparound semantics.
    """
    a = np.asarray(a)
    out = np.zeros_like(a)
    np.cumsum(a[:-1], dtype=a.dtype, out=out[1:])
    return out


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------

def digit_histograms(keys: np.ndarray, r: int, group: int,
                     block_size: int) -> np.ndarray:
    """Per-block digit histograms, shape (num_blocks, 2**r).

    Mirrors BuildHistogramsCPU (LSDRadixSort.cu:643-658): block i's row
    counts digit occurrences among keys[i*block_size : (i+1)*block_size].
    Requires len(keys) % block_size == 0, as the reference's benchmarks do.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    assert keys.size % block_size == 0
    digits = get_digit_np(keys, r, group).reshape(-1, block_size)
    bins = 1 << r
    nb = digits.shape[0]
    hist = np.zeros((nb, bins), dtype=np.uint32)
    flat = digits + (np.arange(nb, dtype=np.int64)[:, None] * bins)
    counts = np.bincount(flat.ravel(), minlength=nb * bins)
    hist[:] = counts.reshape(nb, bins)
    return hist


# ---------------------------------------------------------------------------
# Transpose
# ---------------------------------------------------------------------------

def transpose(a: np.ndarray) -> np.ndarray:
    """Matrix transpose (Transpose, LSDRadixSort.cu:483-494)."""
    return np.ascontiguousarray(np.asarray(a).T)


# ---------------------------------------------------------------------------
# Query operators (north-star extensions; BASELINE.json configs 3-4)
# ---------------------------------------------------------------------------

def filter_keys(keys: np.ndarray, lo: int, hi: int):
    """Selection: rows with lo <= key < hi, order-preserving."""
    keys = np.asarray(keys)
    mask = (keys >= lo) & (keys < hi)
    return keys[mask]


def group_by_sum(group_keys: np.ndarray, values: np.ndarray):
    """GROUP BY group_keys SUM(values); returns (unique_keys_sorted, sums).

    Sums wrap in the value dtype (uint32/uint64 modular arithmetic) so the
    device kernels can match bit-exactly.
    """
    gk = np.asarray(group_keys)
    vals = np.asarray(values)
    uniq, inv = np.unique(gk, return_inverse=True)
    sums = np.zeros(uniq.size, dtype=vals.dtype)
    np.add.at(sums, inv, vals)
    return uniq, sums


def hash_join(build_keys: np.ndarray, build_vals: np.ndarray,
              probe_keys: np.ndarray, probe_vals: np.ndarray):
    """Inner equi-join, unique build keys (primary-key join).

    Returns (matched_probe_keys, matched_probe_vals, matched_build_vals) in
    probe order — the canonical output the device kernel must reproduce
    bit-exactly.
    """
    bk = np.asarray(build_keys)
    order = np.argsort(bk, kind="stable")
    bk_s, bv_s = bk[order], np.asarray(build_vals)[order]
    pk = np.asarray(probe_keys)
    pos = np.searchsorted(bk_s, pk)
    pos_c = np.minimum(pos, bk_s.size - 1)
    hit = bk_s[pos_c] == pk
    return pk[hit], np.asarray(probe_vals)[hit], bv_s[pos_c[hit]]


def hash_join_multi(build_keys: np.ndarray, build_vals: np.ndarray,
                    probe_keys: np.ndarray, probe_vals: np.ndarray):
    """Inner equi-join with DUPLICATE build keys allowed (many-to-many).

    Probe-major output: for each probe row in input order, one output row
    per matching build row, in stable build order (original build position
    for equal keys). Returns (probe_keys, probe_vals, build_vals) arrays of
    total-match length.
    """
    bk = np.asarray(build_keys)
    order = np.argsort(bk, kind="stable")
    bk_s, bv_s = bk[order], np.asarray(build_vals)[order]
    pk = np.asarray(probe_keys)
    pv = np.asarray(probe_vals)
    lo = np.searchsorted(bk_s, pk, side="left")
    hi = np.searchsorted(bk_s, pk, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    p = np.repeat(np.arange(pk.size), cnt)           # probe id per out row
    o = np.cumsum(cnt) - cnt                          # exclusive offsets
    d = np.arange(total) - o[p]                       # dup index within run
    return pk[p], pv[p], bv_s[lo[p] + d]
