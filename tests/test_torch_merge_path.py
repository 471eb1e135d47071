"""The merge-path partition of the port's merge pass
(lsdradixsort_tpu_torch/kernels/merge.py `merge_path_splits`) on CPU
tensors — its plain PyTorch version, which the card's partition kernel is
held against — against a brute-force stable rank in numpy: for every
output tile of TILE rows of a group of up to 8 runs, the number of rows
of each run that the merged order (compared words unsigned, then run,
then position) puts before the tile's first row."""
import numpy as np
import pytest

from lsdradixsort_tpu_torch.core.convert import from_numpy
from lsdradixsort_tpu_torch.kernels import merge as M

T = M.TILE


def _brute(cols, run_len):
    """Co-ranks at every tile start, by a stable lexsort of each group."""
    n = cols[0].shape[0]
    nruns = n // run_len
    out = []
    for g0 in range(0, nruns, M.KWAY):
        lo, hi = g0 * run_len, min(g0 + M.KWAY, nruns) * run_len
        seg = [c[lo:hi].astype(np.int64) for c in cols]
        order = np.lexsort((np.arange(hi - lo), *reversed(seg)))
        run = order // run_len
        for r in range(0, hi - lo, T):
            out.append(np.bincount(run[:r], minlength=M.KWAY))
    return np.array(out, dtype=np.int64).reshape(-1, M.KWAY)


def _case(kind, run_len, nruns, ncmp, seed):
    """ncmp compared columns, sorted within each run."""
    rng = np.random.default_rng(seed)
    n = run_len * nruns
    hi = {"all_equal": 1, "few": 3, "uniform": 2**32, "padded": 2**32}[kind]
    cols = [rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(ncmp)]
    if kind == "padded":           # merge_sort's 0xFFFFFFFF tail: the
        for c in cols:             # last group's runs all padding
            c[(nruns - nruns % M.KWAY or nruns - M.KWAY) * run_len:] = (
                0xFFFFFFFF)
    for r in range(nruns):
        s = slice(r * run_len, (r + 1) * run_len)
        order = np.lexsort(tuple(c[s] for c in reversed(cols)))
        for c in cols:
            c[s] = c[s][order]
    return cols


CASES = [  # kind, run_len, nruns: full and short groups, runs below a tile
    ("all_equal", 1 << 12, 8),
    ("few", 3000, 13),
    ("padded", 1 << 11, 21),
    ("uniform", 1000, 5),
    ("uniform", 3, 19),
    ("few", 1, 40),
]


@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("kind,run_len,nruns", CASES)
def test_merge_path_splits_plain_matches_brute_force(kind, run_len, nruns,
                                                      ncmp):
    cols = _case(kind, run_len, nruns, ncmp, seed=90 + ncmp)
    # a rider past the compared words changes nothing
    rider = np.arange(cols[0].shape[0], dtype=np.uint32)[::-1].copy()
    got = M.merge_path_splits(from_numpy(cols[0]),
                              [from_numpy(c) for c in cols[1:]]
                              + [from_numpy(rider)], run_len, ncmp)
    want = _brute(cols, run_len)
    assert got.shape == (M.tile_plan(cols[0].shape[0], run_len)[1], M.KWAY)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,run_len,plan", [
    (0, 4, (1, 0)),
    (8 * T, T, (8, 8)),               # one full group
    (13 * T, T, (8, 13)),             # a short last group
    (21 * 2048, 2048, (4, 11)),       # tiles of two runs; 5 in the last
    (57, 3, (1, 3)),                  # groups smaller than a tile
])
def test_tile_plan(n, run_len, plan):
    assert M.tile_plan(n, run_len) == plan


def test_splits_counters_count_plain_calls_on_cpu():
    cols = _case("uniform", 1 << 10, 8, 1, seed=95)
    launches, plain = dict(M.LAUNCHES), dict(M.PLAIN_CALLS)
    M.merge_path_splits(from_numpy(cols[0]), [], 1 << 10)
    assert M.LAUNCHES == launches
    assert M.PLAIN_CALLS["merge_path_splits"] == (
        plain["merge_path_splits"] + 1)
