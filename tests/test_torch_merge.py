"""The port's 8-way merge pass (lsdradixsort_tpu_torch/kernels/merge.py)
on CPU tensors — its plain PyTorch version — against the JAX package's
Pallas merge pass in interpret mode, on the same numpy input.

Shrunken geometry as tests/test_merge.py: runs of 2^10, blk=128,
buf=2^13 on the JAX side (the port needs neither). Outputs are integers
and must agree bit for bit.

The CUDA tile merge (csrc/merge.cu merge_tiles) cannot run here, so a
plain model of it (`_model_tile`: the windows' 16-byte covers, the tree
of merge-path searches and sequential merges thread by thread, the
riders' gather through the rows' places) is held against the plain
versions and the JAX pass on adversarial tiles: ties across all 8 runs
with distinct riders, all-equal keys, tiles drawn from one window (the
others empty), runs of 2^6 to 2^12, ncmp 1-3, and ranges of
merge_pass_runs; its constants are held to the source.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import merge as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, row_order, to_numpy
from lsdradixsort_tpu_torch.kernels import merge as T

L = 1 << 10
BLK = 128
MAXBUF = 1 << 13


def _runs(cols, nruns):
    """Sort each run of L rows of (key, val0, riders...) by (key, val0)."""
    out = [c.reshape(nruns, L).copy() for c in cols]
    for r in range(nruns):
        order = (np.lexsort((out[1][r], out[0][r])) if len(cols) > 1
                 else np.argsort(out[0][r], kind="stable"))
        for c in out:
            c[r] = c[r][order]
    return [c.reshape(-1) for c in out]


def _jax_pass(cols):
    buf = J.pass_buf_elems(L, MAXBUF)
    tab, ok = J.merge_pass_tables(jnp.asarray(cols[0]), L, buf, BLK)
    assert bool(ok)
    k, vs = J.merge_pass_multi(jnp.asarray(cols[0]),
                               [jnp.asarray(c) for c in cols[1:]], tab,
                               run_len=L, buf_elems=buf, blk=BLK)
    return [np.asarray(k)] + [np.asarray(v) for v in vs]


def _port_pass(cols):
    k, vs = T.merge_pass_multi(from_numpy(cols[0]),
                               [from_numpy(c) for c in cols[1:]], L)
    return [to_numpy(k)] + [to_numpy(v) for v in vs]


@pytest.mark.parametrize("npay,nruns", [(0, 8), (1, 8), (2, 8), (2, 4)])
def test_merge_pass_matches_jax(npay, nruns):
    # a full group of 8 runs, and a pass whose only group holds 4 runs
    rng = np.random.default_rng(20 + npay)
    n = nruns * L
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[: n // 4] %= 37                                  # heavy ties too
    cols = [k, np.arange(n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)]
    cols = _runs(cols[:1 + npay], nruns)
    want = _jax_pass(cols)
    got = _port_pass(cols)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.sort(cols[0]))


def test_merge_pass_payload_compared_unsigned():
    # val0 breaks key ties unsigned (merge.py:388-389), unlike
    # sort_tiles_kv's signed compare; riders follow their rows
    rng = np.random.default_rng(23)
    n = 8 * L
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v0 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v1 = np.arange(n, dtype=np.uint32)
    cols = _runs([k, v0, v1], 8)
    want = _jax_pass(cols)
    got = _port_pass(cols)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    order = np.lexsort((cols[1], cols[0]))
    np.testing.assert_array_equal(got[1], cols[1][order])


@pytest.mark.parametrize("nruns", [16, 11, 2])
def test_merge_pass_groups_plain(nruns):
    # several groups, a ragged last group, and a 2-run pass: each group of
    # up to 8 runs becomes one stably merged run
    rng = np.random.default_rng(24)
    n = nruns * L
    cols = _runs([rng.integers(0, 50, n, dtype=np.uint32),
                  np.arange(n, dtype=np.uint32)], nruns)
    got = _port_pass(cols)
    for g in range(0, nruns, 8):
        s = slice(g * L, min(g + 8, nruns) * L)
        order = np.lexsort((cols[1][s], cols[0][s]))
        np.testing.assert_array_equal(got[0][s], cols[0][s][order])
        np.testing.assert_array_equal(got[1][s], cols[1][s][order])


def test_merge_pass_wrappers_and_counters():
    rng = np.random.default_rng(25)
    k = _runs([rng.integers(0, 9, 8 * L, dtype=np.uint32),
               np.arange(8 * L, dtype=np.uint32)], 8)
    launches, plain = dict(T.LAUNCHES), dict(T.PLAIN_CALLS)
    keys = to_numpy(T.merge_pass(from_numpy(k[0]), L))
    sk, sv = T.merge_pass_kv(from_numpy(k[0]), from_numpy(k[1]), L)
    np.testing.assert_array_equal(keys, np.sort(k[0]))
    np.testing.assert_array_equal(to_numpy(sk), keys)
    np.testing.assert_array_equal(to_numpy(sv),
                                  k[1][np.lexsort((k[1], k[0]))])
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["merge_pass_multi"] == plain["merge_pass_multi"] + 2


def test_merge_pass_invalid_inputs_raise():
    k = torch.zeros(3 * L, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        T.merge_pass(k, 0)                             # no run length
    # n % run_len != 0 merges a group whose last run is short
    x = np.concatenate([np.arange(2 * L), np.arange(L)]).astype(np.uint32)
    np.testing.assert_array_equal(to_numpy(T.merge_pass(from_numpy(x), 2 * L)),
                                  np.sort(x))
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k] * 8, L)              # too many streams
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k, k], L, ncmp=4)
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k], L, ncmp=3)          # 2 streams
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k[:L]], L)              # length mismatch


# ---------------------------------------------------------------------------
# A plain model of the CUDA tile merge (csrc/merge.cu merge_tiles), which
# the CPU cannot run: the same windows, bulk-copy covers, merge-path
# searches and sequential merges, thread by thread, level by level, on
# numpy words. It is held against the plain versions and the JAX pass on
# adversarial tiles, so that the kernel's design is checked for exactness
# here; the card checks the kernel against the plain versions.
# ---------------------------------------------------------------------------

K_TILE = T.TILE                # rows of a table tile (csrc/merge.cu kTile)
K_THREADS = 256                # a CTA; at the first level warp 0 plans
K_STRIDE = K_TILE + 64         # words of a stream's array in shared memory
GARBAGE = 0xA5A5A5A5           # shared memory the copies did not write
KWAY_ = T.KWAY


def _mergers(w_seg):
    """(threads, output rows a thread) of a level."""
    threads = K_THREADS - 32 if w_seg == 2 else K_THREADS
    return threads, K_TILE // threads + 1


def _model_level(src, dst, isrc, idst, off, pos, w_seg, rows, ncmp):
    """One level: segments of w_seg windows, each the stable merge of its
    halves, from src to dst (per-stream arrays); the first level
    (w_seg = 2) reads each window at its copy's place pos[w][j], the later
    ones the merged layout; rows carry their places (isrc -> idst)."""
    threads, run = _mergers(w_seg)
    for t in range(threads):
        o0 = t * run
        if o0 >= rows:
            continue
        seg = 0
        while off[(seg + 1) * w_seg] <= o0:
            seg += 1

        def enter(sg):
            lo, mid = off[sg * w_seg], off[sg * w_seg + w_seg // 2]
            hi = off[(sg + 1) * w_seg]
            if w_seg == 2:
                ba = [pos[w][2 * sg] for w in range(ncmp)]
                bb = [pos[w][2 * sg + 1] for w in range(ncmp)]
            else:
                ba, bb = [lo] * ncmp, [mid] * ncmp
            return lo, mid, hi, ba, bb

        lo, mid, hi, ba, bb = enter(seg)

        def row(from_a, i, j):
            return tuple(int(src[w][ba[w] + i if from_a else bb[w] + j])
                         for w in range(ncmp))

        def place(at):
            return at if w_seg == 2 else int(isrc[at])

        d = o0 - lo
        a, e = max(0, d - (hi - mid)), min(d, mid - lo)
        while a < e:                       # ties: the left half first
            h = (a + e) // 2
            if row(False, 0, d - 1 - h) < row(True, h, 0):
                e = h
            else:
                a = h + 1
        i, j = a, d - a
        ra, rb = row(True, i, 0), row(False, 0, j)
        xa, xb = place(lo + i), place(mid + j)
        for o in range(o0, min(o0 + run, rows)):
            if o == hi:                    # the next segment that has rows
                while hi == o:
                    seg += 1
                    lo, mid, hi, ba, bb = enter(seg)
                i = j = 0
                ra, rb = row(True, 0, 0), row(False, 0, 0)
                xa, xb = place(lo), place(mid)
            take_a = j >= hi - mid or (i < mid - lo and not rb < ra)
            for w in range(ncmp):
                dst[w][o] = (ra if take_a else rb)[w]
            idst[o] = xa if take_a else xb
            if take_a:
                i += 1
                ra, xa = row(True, i, 0), place(lo + i)
            else:
                j += 1
                rb, xb = row(False, 0, j), place(mid + j)


def _model_tile(runs, c0, c1, ncmp, resid):
    """One tile: runs[j][t] is stream t of run j (numpy uint32), window j
    its rows [c0[j], c1[j]), resid[t] the word address of stream t's row 0
    mod 4. Each compared stream's windows land at their 16-byte covers'
    places; three levels (pairs, quads, all 8) ping-pong between the stage
    and a work buffer; riders are gathered through the rows' places.
    Returns the tile's streams."""
    ns = len(runs[0])
    lens = [b - a for a, b in zip(c0, c1)] + [0] * (KWAY_ - len(c0))
    off = [0]
    for ln in lens:
        off.append(off[-1] + ln)
    rows = off[-1]
    stage = [np.full(K_STRIDE, GARBAGE, np.uint64) for _ in range(ncmp)]
    pos = [[0] * KWAY_ for _ in range(ncmp)]
    for w in range(ncmp):
        at = 0
        for j in range(len(c0)):
            addr = resid[w] + c0[j]
            first, end = addr & ~3, (addr + lens[j] + 3) & ~3
            words = end - first if lens[j] else 0
            for k in range(words):         # the cover, the run's words
                q = first + k - resid[w]
                if 0 <= q < len(runs[j][w]):
                    stage[w][at + k] = runs[j][w][q]
            pos[w][j] = at + addr - first
            at += words
        assert at < K_STRIDE
    work = [np.full(K_STRIDE, GARBAGE, np.uint64) for _ in range(ncmp)]
    idx0 = np.zeros(K_STRIDE, np.int64)
    idx1 = np.zeros(K_STRIDE, np.int64)
    _model_level(stage, work, None, idx0, off, pos, 2, rows, ncmp)
    _model_level(work, stage, idx0, idx1, off, pos, 4, rows, ncmp)
    _model_level(stage, work, idx1, idx0, off, pos, 8, rows, ncmp)
    out = [work[w][:rows].astype(np.uint32) for w in range(ncmp)]
    for t in range(ncmp, ns):
        staged = np.concatenate([runs[j][t][a:b]
                                 for j, (a, b) in enumerate(zip(c0, c1))])
        out.append(staged[idx0[:rows]])
    return out


def _model_pass(cols, run, ncmp, resid):
    """A merge_pass_multi pass through the model, tile by tile, windows
    from the plain partition."""
    n = cols[0].shape[0]
    cor = to_numpy(T.merge_path_splits_plain(
        from_numpy(cols[0]), [from_numpy(c) for c in cols[1:]], run,
        ncmp).view(torch.uint32)).astype(np.int64)
    per_group, total = T.tile_plan(n, run)
    nruns = n // run
    out = [np.zeros(n, np.uint32) for _ in cols]
    for b in range(total):
        g, r = divmod(b, per_group)
        nr = min(KWAY_, nruns - g * KWAY_)
        base = g * KWAY_ * run
        runs = [[c[base + j * run:base + (j + 1) * run] for c in cols]
                for j in range(nr)]
        last = r + 1 == -(-nr * run // K_TILE)
        c0 = list(cor[b, :nr])
        c1 = [run] * nr if last else list(cor[b + 1, :nr])
        for t, part in enumerate(_model_tile(runs, c0, c1, ncmp, resid)):
            out[t][base + r * K_TILE:base + r * K_TILE + len(part)] = part
    return out


def _family(fam, nruns, run, rng):
    n = nruns * run
    if fam == "ties8":                     # 3 keys, ties across all runs
        return rng.integers(0, 3, n, dtype=np.uint32)
    if fam == "all_equal":
        return np.full(n, 0x5EED, np.uint32)
    if fam == "one_window":                # disjoint ranges: empty windows
        order = rng.permutation(nruns).astype(np.uint64)
        width = (1 << 32) // nruns
        return (order[:, None] * width + rng.integers(
            0, width, (nruns, run), dtype=np.uint64)).reshape(-1).astype(
                np.uint32)
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _sorted_runs(cols, run, ncmp):
    """Each run of the streams sorted by its first ncmp words, stably."""
    perm = row_order([from_numpy(c) for c in cols[:ncmp]], run).numpy()
    return [np.take_along_axis(c.reshape(-1, run), perm, 1).reshape(-1)
            for c in cols]


@pytest.mark.parametrize("fam,lg,nruns,ns,ncmp", [
    ("ties8", 9, 8, 3, 2), ("ties8", 12, 8, 4, 1), ("ties8", 6, 13, 3, 3),
    ("all_equal", 12, 8, 2, 2), ("all_equal", 6, 8, 1, 1),
    ("one_window", 12, 11, 3, 1), ("one_window", 9, 8, 3, 3),
    ("uniform", 6, 16 + 5, 2, 2), ("uniform", 12, 8, 8, 3),
    ("uniform", 10, 8, 1, 1)])
def test_tile_merge_model_matches_plain(fam, lg, nruns, ns, ncmp):
    # ties across all 8 runs with distinct riders (stability), all-equal
    # keys, tiles drawn from one window (the others empty), runs of 2^6
    # (shorter than a tile, a last group of 5 runs) to 2^12; each stream's
    # row 0 at its own word address mod 4, so covers start everywhere
    rng = np.random.default_rng(40 + lg + ns)
    run = 1 << lg
    n = nruns * run
    cols = [_family(fam, nruns, run, rng)] + [
        rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        if i else np.arange(n, dtype=np.uint32) for i in range(ns - 1)]
    if ncmp >= 2 and fam in ("ties8", "all_equal"):
        cols[1] %= 5                       # ties on the second word too
    cols = _sorted_runs(cols, run, ncmp)
    resid = [(lg + t) % 4 for t in range(ns)]
    got = _model_pass(cols, run, ncmp, resid)
    k, vs = T.merge_pass_multi_plain(from_numpy(cols[0]),
                                     [from_numpy(c) for c in cols[1:]], run,
                                     ncmp)
    for g, want in zip(got, [k, *vs], strict=True):
        np.testing.assert_array_equal(g, to_numpy(want))


@pytest.mark.parametrize("fam,ns", [("ties8", 3), ("ties8", 2),
                                    ("all_equal", 1)])
def test_tile_merge_model_matches_jax(fam, ns):
    # the JAX pass at the shapes and default ncmp of
    # test_merge_pass_matches_jax (8 runs of 2^10, so its compiled kernels
    # serve): 3 keys tied across all runs with distinct riders, and
    # all-equal keys
    rng = np.random.default_rng(60 + ns)
    n = 8 * L
    ncmp = min(2, ns)
    cols = [_family(fam, 8, L, rng), np.arange(n, dtype=np.uint32),
            rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)]
    cols = _sorted_runs(cols[:ns], L, ncmp)
    got = _model_pass(cols, L, ncmp, [1, 2, 3][:ns])
    for g, want in zip(got, _jax_pass(cols), strict=True):
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("S,ns,ncmp", [(8, 3, 2), (3, 2, 1), (5, 4, 3)])
def test_tile_merge_model_on_a_range(S, ns, ncmp):
    # merge_pass_runs' tiles: S runs of unequal lengths in buffers of
    # their own, one range that starts mid-run, windows from the plain
    # range partition
    rng = np.random.default_rng(70 + S)
    lens = [int(v) for v in rng.integers(700, 5000, S)]
    streams = [[] for _ in range(ns)]
    for ln in lens:
        cols = [rng.integers(0, 7, ln, dtype=np.uint32)] + [
            rng.integers(0, 2 ** 32, ln, dtype=np.uint64).astype(np.uint32)
            for _ in range(ns - 1)]
        for t, c in enumerate(_sorted_runs(cols, ln, ncmp)):
            streams[t].append(c)
    lo_rank = sum(lens) // 5
    count = min(2 * K_TILE + 777, sum(lens) - lo_rank)
    kw = dict(chunk0=0, nchunks=1, chunk_elems=count, blk=T.DEF_BLK,
              ncmp=ncmp)
    tab = T.window_table([0] * S, lens, lo_rank)
    tstreams = [[from_numpy(r) for r in rs] for rs in streams]
    cor = to_numpy(T.merge_runs_splits_plain(tstreams, tab, **kw)
                   .view(torch.uint32)).astype(np.int64)
    runs = [[streams[t][j] for t in range(ns)] for j in range(S)]
    got = [np.concatenate(parts) for parts in zip(*[
        _model_tile(runs, list(cor[b, :S]), list(cor[b + 1, :S]), ncmp,
                    [3, 0, 1, 2, 3, 0, 1, 2][:ns])
        for b in range(cor.shape[0] - 1)])]
    want = T.merge_pass_runs_plain(tstreams, tab, buf_elems=T.DEF_BUF, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, to_numpy(w))


def test_tile_merge_model_constants_match_the_source():
    src = (Path(__file__).resolve().parents[1] / "lsdradixsort_tpu_torch"
           / "csrc" / "merge.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1)
    assert int(const("kTile")) == K_TILE
    assert int(const("kMergeThreads")) == K_THREADS
    assert const("kRun1") == "kTile / (kMergeThreads - 32) + 1"
    assert const("kRun") == "kTile / kMergeThreads + 1"
    assert const("kStride") == f"kTile + {K_STRIDE - K_TILE}"
