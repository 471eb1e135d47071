"""The merge-path partition of the port's merge pass
(lsdradixsort_tpu_torch/kernels/merge.py `merge_path_splits`) on CPU
tensors — its plain PyTorch version, which the card's partition kernel is
held against — against a brute-force stable rank in numpy: for every
output tile of TILE rows of a group of up to 8 runs, the number of rows
of each run that the merged order (compared words unsigned, then run,
then position) puts before the tile's first row. Then a plain-torch
model of how the card's kernel brackets those co-ranks from samples, and
of the check that accepts its cut, held against the same brute force."""
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core.convert import from_numpy, row_order
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
    if kind == "padded":           # a tail of all-ones rows: the last
        for c in cols:             # group's runs all 0xFFFFFFFF
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


# --- the card's partition design, modelled ----------------------------------
#
# csrc/merge.cu finds each boundary's co-ranks from brackets lo_j <= c_j <=
# hi_j that a sample of each run's bracket gives: every step_j-th row
# (at most M a run), each sample x ranked against the other runs' samples
# only, so that its clamped rank (its position plus, per other run m, its
# rank in m clamped to [lo_m, hi_m]) lies in [gl, gu]; run j's bracket for
# rank r runs from after its last sample with gu < r to its first sample
# with gl >= r, then is cut to what the other brackets allow. The kernel is
# exact only if every true co-rank lies in its bracket: this plain-torch
# model of that derivation is held against brute-force co-ranks on the
# adversarial inputs the card's checks use, and so is the check that
# accepts a cut (every row left of it before every row right of it).

def _before_counts(a_cols, b_cols, or_equal):
    """For each row of b, the rows of sorted a ordered before it (rows
    equal on every word count when or_equal): a stable sort of a's rows
    and b's together, a's first when they win ties."""
    na, nb = a_cols[0].shape[0], b_cols[0].shape[0]
    first, second = (a_cols, b_cols) if or_equal else (b_cols, a_cols)
    cat = [torch.cat([x, y]) for x, y in zip(first, second)]
    order = row_order(cat, na + nb).view(-1)
    is_a = order < na if or_equal else order >= nb
    before = torch.cumsum(is_a.to(torch.int64), 0) - is_a.to(torch.int64)
    counts = torch.empty(nb, dtype=torch.int64)
    counts[order[~is_a] - (na if or_equal else 0)] = before[~is_a]
    return counts


def _model_brackets(cols_by_run, lo, hi, ranks, m_per_run):
    """(lo_b, hi_b): (len(ranks), S) brackets of the co-ranks at `ranks`,
    derived from at most m_per_run samples of each run's bracket [lo, hi]
    as csrc/merge.cu derives them."""
    S = len(cols_by_run)
    step = [-(-(h - l) // m_per_run) if h - l > m_per_run else 1
            for l, h in zip(lo, hi)]
    pos = [torch.arange(l, h, st, dtype=torch.int64)
           for l, h, st in zip(lo, hi, step)]
    samp = [[c[p] for c in cols] for cols, p in zip(cols_by_run, pos)]
    gl = [p.clone() for p in pos]
    gu = [p.clone() for p in pos]
    for j in range(S):
        for m in range(S):
            if m == j:
                continue
            cnt = pos[m].shape[0]
            if cnt == 0:
                gl[j] += lo[m]
                gu[j] += lo[m]
                continue
            a = _before_counts(samp[m], samp[j], m < j)
            gl[j] += torch.where(a == 0, lo[m], lo[m] + (a - 1) * step[m] + 1)
            gu[j] += torch.where(a == cnt, hi[m], lo[m] + a * step[m])
    r = torch.as_tensor(ranks, dtype=torch.int64)
    lo_b = torch.empty((r.shape[0], S), dtype=torch.int64)
    hi_b = torch.empty_like(lo_b)
    for j in range(S):
        cnt = pos[j].shape[0]
        if cnt == 0:
            lo_b[:, j], hi_b[:, j] = lo[j], hi[j]
            continue
        k = torch.searchsorted(gu[j], r)        # the samples with gu < r
        lo_b[:, j] = torch.where(k > 0, pos[j][(k - 1).clamp(min=0)] + 1,
                                 lo[j])
        k = torch.searchsorted(gl[j], r)        # the first with gl >= r
        hi_b[:, j] = torch.where(k < cnt, pos[j][k.clamp(max=cnt - 1)],
                                 hi[j])
    slo, shi = lo_b.sum(1, keepdim=True), hi_b.sum(1, keepdim=True)
    cut_lo = torch.maximum(lo_b, r[:, None] - (shi - hi_b))
    cut_hi = torch.minimum(hi_b, r[:, None] - (slo - lo_b))
    return cut_lo, cut_hi


def _cut_checks(runs, cut, lo, hi, ncmp):
    """The card's check of a cut whose rows sum to r: row c_j - 1 of each
    run before row c_m of every other run (compared words, then run),
    wherever the brackets [lo, hi] leave either row open."""
    S = len(runs)
    for j in range(S):
        if cut[j] <= lo[j]:
            continue
        left = [int(c[cut[j] - 1]) for c in runs[j][:ncmp]]
        for m in range(S):
            if m == j or cut[m] >= hi[m]:
                continue
            right = [int(c[cut[m]]) for c in runs[m][:ncmp]]
            if not (left < right or (left == right and j < m)):
                return False
    return True


def _family(kind, n, rng):
    """n compared words of one adversarial family."""
    if kind == "uniform":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "all_equal":
        return np.full(n, 0x5EEDBEEF, np.uint32)
    if kind == "few":
        return rng.integers(0, 3, n).astype(np.uint32)
    if kind == "hot90":           # one key 90 % of the rows
        x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        x[rng.random(n) < 0.9] = 0x80000000
        return x
    assert kind == "presorted"    # runs that follow each other: cuts on
    return np.arange(n, dtype=np.uint32)  # multiples of the tile


def _sorted_runs(kind, lens, ncmp, seed):
    """Runs of the given lengths, each sorted on its ncmp compared words
    (the first of the family, the rest uniform), as numpy columns."""
    rng = np.random.default_rng(seed)
    total = int(sum(lens))
    cols = [_family(kind, total, rng)] + [
        rng.integers(0, 2**32, total, dtype=np.uint64).astype(np.uint32)
        for _ in range(ncmp - 1)]
    out, at = [], 0
    for L in lens:
        run = [c[at:at + L] for c in cols]
        order = np.lexsort(tuple(reversed(run)))
        out.append([c[order] for c in run])
        at += L
    return out


MODEL_KINDS = ["uniform", "all_equal", "few", "hot90", "presorted"]


@pytest.mark.parametrize("m_per_run", [4, 64])
@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("kind,run_len,nruns", [
    (k, rl, nr) for k in MODEL_KINDS
    for rl, nr in ((1 << 10, 8), (4033, 7), (1 << 12, 5), (1 << 15, 3))])
def test_model_brackets_hold_the_groups_coranks(kind, run_len, nruns, ncmp,
                                                m_per_run):
    # a group of up to 8 runs: level 0's brackets (whole runs) and a
    # span's (the exact co-ranks 8 tiles apart), each boundary's true
    # co-ranks inside the brackets its samples give, and the check
    # accepting the true cut and refusing a cut one row off
    runs = _sorted_runs(kind, [run_len] * nruns, ncmp, seed=run_len + ncmp)
    flat = [np.concatenate([r[i] for r in runs]) for i in range(ncmp)]
    want = _brute(flat, run_len)[:, :nruns]
    tiles = want.shape[0]
    ranks = np.arange(tiles) * T
    cols = [[from_numpy(c) for c in r] for r in runs]
    spans = [(0, None)] + [(t0, min(t0 + 8, tiles)) for t0 in
                           range(0, tiles, 8)]
    for t0, t1 in spans:
        if t1 is None:
            lo, hi, sel = [0] * nruns, [run_len] * nruns, range(tiles)
        else:
            lo = [int(v) for v in want[t0]]
            hi = ([int(v) for v in want[t1]] if t1 < tiles
                  else [run_len] * nruns)
            sel = range(t0, t1)
        lo_b, hi_b = _model_brackets(cols, lo, hi, ranks[list(sel)],
                                     m_per_run)
        true = torch.as_tensor(want[list(sel)])
        assert bool((lo_b <= true).all()) and bool((true <= hi_b).all())
    for t in range(tiles):
        c = [int(v) for v in want[t]]
        assert _cut_checks(runs, c, [0] * nruns, [run_len] * nruns, ncmp)
        for a in range(nruns):
            for b in range(nruns):
                if a != b and c[a] > 0 and c[b] < run_len:
                    off = list(c)
                    off[a] -= 1
                    off[b] += 1
                    assert not _cut_checks(runs, off, [0] * nruns,
                                           [run_len] * nruns, ncmp)


@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("kind,S", [(k, S) for k in MODEL_KINDS
                                    for S in (2, 8)])
def test_model_brackets_hold_the_range_coranks(kind, S, ncmp):
    # one range of merge_pass_runs: runs of unequal lengths (one shorter
    # than a sample stride), windows cut around the range, brackets from
    # the windows and from the exact co-ranks of a span inside the range
    rng = np.random.default_rng(S * 5 + ncmp)
    lens = [int(v) for v in rng.integers(1 << 13, 1 << 15, S)]
    lens[0] = 40
    runs = _sorted_runs(kind, lens, ncmp, seed=S + ncmp)
    total = sum(lens)
    count = min(6 * T + 777, total - 1000)
    lo_rank = int(rng.integers(0, total - count))
    want = _brute_runs(runs, ncmp, lo_rank, count)[:, :S]
    first = [max(int(c) - 200, 0) for c in want[0]]
    end = [min(int(c) + 200, L) for c, L in zip(want[-1], lens)]
    edges = lo_rank + np.minimum(np.arange(want.shape[0]) * T, count)
    cols = [[from_numpy(c) for c in r] for r in runs]
    last = want.shape[0] - 1
    for lo, hi, sel in ((first, end, range(last + 1)),
                        ([int(v) for v in want[1]],
                         [int(v) for v in want[last - 1]],
                         range(1, last))):
        for m_per_run in (4, 64):
            lo_b, hi_b = _model_brackets(cols, lo, hi, edges[list(sel)],
                                         m_per_run)
            true = torch.as_tensor(want[list(sel)])
            assert bool((lo_b <= true).all()) and bool((true <= hi_b).all())
    for i in range(want.shape[0]):
        assert _cut_checks(runs, [int(v) for v in want[i]], first, end,
                           ncmp)


@pytest.mark.parametrize("seed", range(6))
def test_model_brackets_hold_every_rank_of_small_runs(seed):
    # every rank of 40 small merges (runs of 0-60 rows, 2-4 key values or
    # uniform, 1-3 compared words, 1-5 samples a run): each co-rank inside
    # the bracket the samples give, and the true cut accepted
    rng = np.random.default_rng(1000 + seed)
    for _ in range(40):
        S = int(rng.integers(1, 9))
        ncmp = int(rng.integers(1, 4))
        hi_key = int(rng.choice([2, 4, 2**32]))
        lens = [int(v) for v in rng.integers(0, 61, S)]
        runs = []
        for L in lens:
            cols = [rng.integers(0, hi_key, L, dtype=np.uint64)
                    .astype(np.uint32) for _ in range(ncmp)]
            order = np.lexsort(tuple(reversed(cols)))
            runs.append([c[order] for c in cols])
        total = sum(lens)
        run, _ = _merged(runs, ncmp)
        ranks = np.arange(total + 1)
        want = np.stack([np.searchsorted(np.flatnonzero(run == s), ranks)
                         for s in range(S)], axis=1)
        cols = [[from_numpy(c) for c in r] for r in runs]
        lo_b, hi_b = _model_brackets(cols, [0] * S, lens, ranks,
                                     int(rng.integers(1, 6)))
        true = torch.as_tensor(want)
        assert bool((lo_b <= true).all()) and bool((true <= hi_b).all())
        for r in range(total + 1):
            assert _cut_checks(runs, [int(v) for v in want[r]], [0] * S,
                               lens, ncmp)
