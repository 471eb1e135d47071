"""The merge-path partition of the port's merge pass
(lsdradixsort_tpu_torch/kernels/merge.py `merge_path_splits`) on CPU
tensors — its plain PyTorch version, which the card's partition kernel is
held against — against a brute-force stable rank in numpy: for every
output tile of TILE rows of a group of up to 8 runs, the number of rows
of each run that the merged order (compared words unsigned, then run,
then position) puts before the tile's first row."""
import numpy as np
import pytest
import torch

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


# --- the partition of one range of merge_pass_runs --------------------------
#
# S sorted runs in separate buffers of unequal lengths; one range of ranks
# [lo_rank, lo_rank + count) of their merged order (compared words, then
# run, then position), seen through windows of rows [first_s, end_s) that
# hold it: the partition gives, at every tile boundary lo_rank + min(i *
# TILE, count), the rows of each run ranked before it.

def _merged(cols_by_run, ncmp):
    """(run, position) of every row in the stable merged order of the
    runs, each run's ncmp compared columns given in full."""
    runs = np.concatenate([np.full(c[0].shape[0], s)
                           for s, c in enumerate(cols_by_run)])
    pos = np.concatenate([np.arange(c[0].shape[0]) for c in cols_by_run])
    keys = [np.concatenate([c[i] for c in cols_by_run]).astype(np.int64)
            for i in range(ncmp)]
    order = np.lexsort((pos, runs, *reversed(keys)))
    return runs[order], pos[order]


def _brute_runs(cols_by_run, ncmp, lo_rank, count):
    """Co-ranks at the range's tile boundaries, by a stable lexsort."""
    run, _ = _merged(cols_by_run, ncmp)
    edges = lo_rank + np.minimum(np.arange(-(-count // T) + 1) * T, count)
    want = np.zeros((edges.shape[0], M.KWAY), np.int64)
    for s in range(len(cols_by_run)):
        want[:, s] = np.searchsorted(np.flatnonzero(run == s), edges)
    return want


def _runs_case(kind, S, ncmp, seed):
    """S runs of unequal lengths (trimmed buffers), ncmp compared columns
    and a rider; a range of 2 * TILE + 1000 ranks that starts mid-window;
    windows of slack rows on either side. Returns (cols_by_run, table,
    kwargs of the range)."""
    rng = np.random.default_rng(seed)
    hi = {"all_equal": 1, "few": 3, "uniform": 2**32}[kind]
    lens = rng.integers(2000, 6000, S)
    cols_by_run = []
    for L in lens:
        cols = [rng.integers(0, hi, L, dtype=np.uint64).astype(np.uint32)
                for _ in range(ncmp)]
        order = np.lexsort(tuple(reversed(cols)))
        cols = [c[order] for c in cols] + [
            rng.integers(0, 2**32, L, dtype=np.uint64).astype(np.uint32)]
        cols_by_run.append(cols)
    total = int(lens.sum())
    count = min(2 * T + 1000, total // 2)
    lo_rank = int(rng.integers(0, total - count))
    want = _brute_runs(cols_by_run, ncmp, lo_rank, count)
    first = [max(int(c) - int(rng.integers(1, 300)), 0) // M.LANES * M.LANES
             for c in want[0, :S]]
    end = [min(int(c) + int(rng.integers(0, 300)), int(L))
           for c, L in zip(want[-1, :S], lens)]
    blk = 256
    kw = dict(chunk0=0, nchunks=1, chunk_elems=count, blk=blk, ncmp=ncmp)
    return cols_by_run, M.window_table(first, end, lo_rank, blk), kw, want


def _streams(cols_by_run):
    return [[from_numpy(c[i]) for c in cols_by_run]
            for i in range(len(cols_by_run[0]))]


def _tile_merges(cols_by_run, splits, ncmp):
    """Each tile's rows: the windows between its two rows of the table,
    concatenated in run order and stably sorted on the compared columns
    (ties keep run order, then position)."""
    streams = []
    for i in range(splits.shape[0] - 1):
        win = [np.concatenate([c[t][splits[i, s]:splits[i + 1, s]]
                               for s, c in enumerate(cols_by_run)])
               for t in range(len(cols_by_run[0]))]
        order = np.lexsort(tuple(reversed(win[:ncmp])))
        streams.append([w[order] for w in win])
    return [np.concatenate(parts) for parts in zip(*streams)]


RUNS_CASES = [(kind, S) for kind in ("all_equal", "few", "uniform")
              for S in (2, 3, 8)]


@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("kind,S", RUNS_CASES)
def test_merge_runs_splits_plain_matches_brute_force(kind, S, ncmp):
    cols_by_run, tab, kw, want = _runs_case(kind, S, ncmp, seed=S * 7 + ncmp)
    got = M.merge_runs_splits(_streams(cols_by_run), tab, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ncmp", [1, 3])
@pytest.mark.parametrize("kind,S", RUNS_CASES)
def test_tile_windows_merge_to_the_range(kind, S, ncmp):
    # the kernel's tiles: the plain merge of each tile's windows, tile by
    # tile, is the range merge_pass_runs_plain writes, every stream
    cols_by_run, tab, kw, _ = _runs_case(kind, S, ncmp, seed=S * 11 + ncmp)
    streams = _streams(cols_by_run)
    splits = M.merge_runs_splits_plain(streams, tab, **kw).numpy()
    whole = M.merge_pass_runs_plain(streams, tab, buf_elems=M.DEF_BUF, **kw)
    for got, want in zip(_tile_merges(cols_by_run, splits, ncmp), whole,
                         strict=True):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("kind,S,nranges", [("all_equal", 8, 4), ("few", 3, 2),
                                            ("uniform", 2, 4)])
def test_merge_runs_splits_on_chunked_ranges(kind, S, nranges):
    # the ranges of merge_runs_chunked: real exact-rank tables (windows
    # rounded to table blocks, holding rows of the neighbouring ranges),
    # run buffers trimmed to unequal lengths after the first range
    from lsdradixsort_tpu_torch.ops import bigsort as B
    rng = np.random.default_rng(97 + S)
    hi = {"all_equal": 1, "few": 3, "uniform": 2**32}[kind]
    L = 2 * T
    keys = [np.sort(rng.integers(0, hi, L, dtype=np.uint64).astype(np.uint32))
            for _ in range(S)]
    runs = [[from_numpy(k) for k in keys],
            [from_numpy(np.arange(s * L, (s + 1) * L, dtype=np.uint32))
             for s in range(S)]]
    real, seen = M.merge_pass_runs, []

    def spy(run_streams, tables, **kw):
        cols = [[r.numpy() for r in rs] for rs in run_streams]
        kw2 = {k: kw[k] for k in ("chunk0", "nchunks", "chunk_elems",
                                  "blk")}
        splits = M.merge_runs_splits_plain(run_streams, tables, **kw2)
        ncmp, lens, first, end, lo_rank, count = M._runs_plan(
            run_streams, tables, *kw2.values(), None)
        seen.append(lens)
        np.testing.assert_array_equal(
            splits.numpy(), _brute_runs(list(zip(*cols)), ncmp, lo_rank,
                                        count))
        got = real(run_streams, tables, **kw)
        for a, b in zip(_tile_merges(list(zip(*cols)), splits.numpy(), ncmp),
                        got, strict=True):
            np.testing.assert_array_equal(a, b.numpy())
        return got

    M.merge_pass_runs = spy
    try:
        B.merge_runs_chunked(runs, chunk_log2=12, nranges=nranges, blk=256)
    finally:
        M.merge_pass_runs = real
    assert len(seen) == nranges and any(len(set(lens)) > 1 for lens in seen)
