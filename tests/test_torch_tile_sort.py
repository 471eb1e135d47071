"""The port's tile sorts (lsdradixsort_tpu_torch/kernels/tile_sort.py) on
CPU tensors — their plain PyTorch versions — against the JAX package's
Pallas tile sorts in interpret mode, on the same numpy input.

Outputs are integers and must agree bit for bit, except where payloads
ride uncompared and the compared words tie: there the TPU network leaves
the order to the network, so those rows are compared as a multiset per
tie group (as tests/test_tile_sort.py:57-75 does).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import tile_sort as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import tile_sort as T


def _np(xs):
    return [np.asarray(x) for x in xs]


def _port(xs):
    return [to_numpy(x) for x in xs]


def _keys(kind, n, rng):
    return {
        "uniform": lambda: rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),
        "all_equal": lambda: np.full(n, 0xDEADBEEF, np.uint32),
        "presorted": lambda: np.arange(n, dtype=np.uint32),
        "reversed": lambda: np.arange(n, dtype=np.uint32)[::-1].copy(),
        "distinct97": lambda: rng.integers(0, 97, n, dtype=np.uint32),
        "extremes": lambda: rng.choice(
            np.array([0, 0xFFFFFFFF], np.uint32), n).astype(np.uint32),
    }[kind]()


KINDS = ["uniform", "all_equal", "presorted", "reversed", "distinct97",
         "extremes"]


@pytest.mark.parametrize("kind", KINDS)
def test_sort_tiles_matches_jax(kind):
    rng = np.random.default_rng(11)
    k = _keys(kind, 4 * 8 * 128, rng)
    want = np.asarray(J.sort_tiles(jnp.asarray(k), tile_rows=8))
    got = to_numpy(T.sort_tiles(from_numpy(k), tile_rows=8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "distinct97"])
def test_sort_tiles_kv_matches_jax(kind):
    rng = np.random.default_rng(12)
    n = 2 * 32 * 128
    k = _keys(kind, n, rng)
    v = np.arange(n, dtype=np.uint32)
    want = _np(J.sort_tiles_kv(jnp.asarray(k), jnp.asarray(v), tile_rows=32))
    got = _port(T.sort_tiles_kv(from_numpy(k), from_numpy(v), tile_rows=32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sort_tiles_kv_compares_val_signed():
    # the JAX kernel casts val to int32 with no bias (tile_sort.py:207): on
    # tied keys, vals >= 2^31 sort BEFORE smaller ones. The port keeps it.
    rng = np.random.default_rng(13)
    n = 4 * 8 * 128
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[:2] = [0x7FFFFFFF, 0x80000000]
    k[:2] = 1
    want = _np(J.sort_tiles_kv(jnp.asarray(k), jnp.asarray(v), tile_rows=8))
    got = _port(T.sort_tiles_kv(from_numpy(k), from_numpy(v), tile_rows=8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tile0 = got[1][:1024][got[0][:1024] == 1].tolist()
    assert tile0.index(0x80000000) < tile0.index(0x7FFFFFFF)


@pytest.mark.parametrize("kind", ["uniform", "distinct97", "extremes"])
def test_sort_tiles_multi_matches_jax(kind):
    # val0 = positions (unique): the order is fully determined
    rng = np.random.default_rng(14)
    n = 2 * 32 * 128
    k = _keys(kind, n, rng)
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, wv = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)],
                                tile_rows=32)
    gk, gv = T.sort_tiles_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)],
                                tile_rows=32)
    for g, w in zip(_port([gk, *gv]), _np([wk, *wv])):
        np.testing.assert_array_equal(g, w)


def test_sort_tiles_multi_one_payload_unsigned():
    # no riders: (key, val0) compared UNSIGNED (tile_sort.py:261)
    rng = np.random.default_rng(15)
    n = 4 * 8 * 128
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, (wv,) = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v)],
                                   tile_rows=8)
    gk, (gv,) = T.sort_tiles_multi(from_numpy(k), [from_numpy(v)],
                                   tile_rows=8)
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))


def test_sort_tiles_multi_tied_compare_pair_multiset():
    # compared (key, val0) ties with a rider: the compared streams are
    # determined; riders match as a multiset per tie group per tile
    rng = np.random.default_rng(5)
    n, tile = 2 * 32 * 128, 32 * 128
    k = rng.integers(0, 4, n, dtype=np.uint32)
    v0 = rng.integers(0, 2, n, dtype=np.uint32)
    v1 = np.arange(n, dtype=np.uint32)
    wk, wv = J.sort_tiles_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)],
                                tile_rows=32)
    wk, (w0, w1) = np.asarray(wk), _np(wv)
    gk, gv = T.sort_tiles_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)], tile_rows=32)
    g0, g1 = _port(gv)
    np.testing.assert_array_equal(to_numpy(gk), wk)
    np.testing.assert_array_equal(g0, w0)
    for t in range(n // tile):
        s = slice(t * tile, (t + 1) * tile)
        got = collections.Counter(zip(wk[s].tolist(), g0[s].tolist(),
                                      g1[s].tolist()))
        want = collections.Counter(zip(wk[s].tolist(), w0[s].tolist(),
                                       w1[s].tolist()))
        assert got == want
    # the port orders riders stably within a tie group
    for t in range(n // tile):
        s = slice(t * tile, (t + 1) * tile)
        order = np.lexsort((v0[s], k[s]))
        np.testing.assert_array_equal(g1[s], v1[s][order])


def test_cpu_wrappers_run_plain_versions_only():
    k = from_numpy(np.arange(1024, dtype=np.uint32)[::-1].copy())
    launches = dict(T.LAUNCHES)
    kernels = dict(T.KERNEL_LAUNCHES)
    designs = dict(T.DESIGN_CALLS)
    plain = dict(T.PLAIN_CALLS)
    T.sort_tiles(k, tile_rows=8)
    T.sort_tiles_kv(k, k, tile_rows=8)
    T.sort_tiles_multi(k, [k, k], tile_rows=8)
    T.sort_tiles_multi(k.repeat(32), [k.repeat(32)] * 2, tile_rows=256)
    assert T.LAUNCHES == launches
    assert T.KERNEL_LAUNCHES == kernels
    assert T.DESIGN_CALLS == designs
    assert {n: T.PLAIN_CALLS[n] - plain[n] for n in plain} == {
        "sort_tiles": 1, "sort_tiles_kv": 1, "sort_tiles_multi": 2}


def test_invalid_inputs_raise():
    # n % tile != 0 sorts every whole tile and the short last one
    x = np.arange(1000, dtype=np.uint32)[::-1].copy()
    got = to_numpy(T.sort_tiles(from_numpy(x), tile_rows=4))
    np.testing.assert_array_equal(got[:512], np.sort(x[:512]))
    np.testing.assert_array_equal(got[512:], np.sort(x[512:]))
    k = torch.zeros(1024, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        T.sort_tiles(k, tile_rows=3)                 # not a power of 2
    with pytest.raises(ValueError):
        T.sort_tiles(k.view(torch.int32), tile_rows=8)   # not uint32
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [k, k], tile_rows=8, ncmp=4)
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [k], tile_rows=8, ncmp=3)  # 2 streams
    with pytest.raises(ValueError):
        T.sort_tiles_multi(k, [], tile_rows=8, ncmp=2)


# --- the cluster kernel's launch plan (kernels/tile_sort.py `tile_plan`) ----
#
# csrc/tile_sort.cu `cluster_sort` runs the schedule the plan hands it, step
# by step; the replay below runs the same steps on numpy rows, as the
# kernel does, and checks the plan's promises.

def _packed(words):
    """Rows of small words (< 8) and a last u32 as one uint64 that orders
    as the words do lexicographically."""
    key = np.zeros(len(words[0]), np.uint64)
    for w in words[:-1]:
        assert w.max() < 8
        key = key << np.uint64(3) | w.astype(np.uint64)
    return key << np.uint64(32) | words[-1].astype(np.uint64)


def _thread_rows(plan, b):
    """The rows of each group a thread holds at a step over bits
    b..b+G-1, for every group of a CTA."""
    g = plan.group_log2
    tid = np.arange(1 << (plan.rows_log2 - g))[:, None]
    e = np.arange(1 << g)[None, :]
    return (tid & ((1 << b) - 1)) | (e << b) | ((tid >> b) << (b + g))


def _replay(plan, key):
    """Run plan.steps over numpy rows (one uint64 key a row, tiles of
    2^tile_log2 rows) as the kernels do; return the sorted keys and the
    (kl, jl, where) of each stage run."""
    t, g, r = plan.tile_log2, plan.group_log2, plan.rows_log2
    key = key.copy()
    n = len(key)
    # bit kl of each row's index in its tile: the direction of phase kl
    local = np.arange(n) & ((1 << t) - 1)
    desc = {kl: (local >> kl) & 1 == 1 for kl in range(1, t)}
    closed = set()
    run = []
    for st in plan.steps:
        for kl, jl in st.stages():
            if st.kind == T.STAGE:
                where = "device"
            elif st.kind == T.GROUP and jl == st.jx:
                where = "cross"
            else:
                where = "registers"
                bits = 0 if st.kind == T.FIRST else st.b
                if (bits, jl) not in closed:
                    # the thread's rows are closed under the partner map
                    # and lie in one CTA
                    rows = _thread_rows(plan, bits)
                    assert rows.max() < 1 << r
                    np.testing.assert_array_equal(
                        np.sort(rows ^ (1 << jl), axis=1),
                        np.sort(rows, axis=1))
                    closed.add((bits, jl))
                # away from the first step, one direction a thread
                if st.kind == T.GROUP:
                    assert not bits <= kl < bits + g
            run.append((kl, jl, where))
            # pairs (row, row + 2^jl) of rows with bit jl clear, as views
            # (rows equal as keys are equal rows: which one moves is moot)
            pairs = key.reshape(-1, 2, 1 << jl)
            lo, hi = pairs[:, 0], pairs[:, 1]
            small, large = np.minimum(lo, hi), np.maximum(lo, hi)
            if kl < t:
                down = desc[kl].reshape(-1, 2, 1 << jl)[:, 0]
                small, large = (np.where(down, large, small),
                                np.where(down, small, large))
            lo[...], hi[...] = small, large
    return key, run


@pytest.mark.parametrize("tile_log2", range(7, 19))
@pytest.mark.parametrize("nwords", [1, 2, 3, 4])
def test_tile_plan(nwords, tile_log2):
    t = tile_log2
    n = 1 << max(t, 15)          # several tiles a CTA below 2^15 rows
    plan = T.tile_plan(nwords, t, n)
    r, s = plan.rows_log2, plan.span_log2
    assert 4 * nwords << r <= plan.smem_bytes <= T.SMEM_LIMIT
    assert plan.cluster in (1, 2, 4)
    assert s == r + plan.cluster.bit_length() - 1
    groups = 1 << (r - plan.group_log2)
    assert plan.threads <= 1024 and groups % plan.threads == 0
    assert n % (1 << s) == 0 and (plan.cluster == 1 or s <= t)
    if t >= 15:
        # the paths' tile fits one cluster: 2^15 / C rows of every word
        # in each CTA
        assert (nwords * 4 << 15) // plan.cluster <= plan.smem_bytes
    if nwords == 1 and t <= 15:
        # keys alone: one CTA a tile (128 KB), no cluster partner
        assert plan.cluster == 1 and plan.smem_bytes == 1 << 17
    rng = np.random.default_rng(t * 8 + nwords)
    random = [rng.integers(0, 3, n, dtype=np.uint32) for _ in range(nwords)]
    random[-1] = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32)
    equal = [np.full(n, 7, np.uint32) for _ in range(nwords)]
    for words in (random, equal):
        got, run = _replay(plan, _packed(words))
        network = [(kl, jl) for kl in range(1, t + 1)
                   for jl in range(kl - 1, -1, -1)]
        assert [(kl, jl) for kl, jl, _ in run] == network
        assert {(kl, jl) for kl, jl, w in run if w == "cross"} == {
            (kl, jl) for kl, jl in network if 1 << r <= 1 << jl < 1 << s}
        assert {(kl, jl) for kl, jl, w in run if w == "device"} == {
            (kl, jl) for kl, jl in network if 1 << jl >= 1 << s}
        if t == 15:
            assert all(w != "device" for _, _, w in run)
        if t == 15 and nwords == 1:
            assert all(w == "registers" for _, _, w in run)
            assert len(plan.steps) == 22       # E = 64 rows a thread
        for tile in range(n >> t):
            sl = slice(tile << t, (tile + 1) << t)
            order = np.lexsort([w[sl] for w in reversed(words)])
            np.testing.assert_array_equal(got[sl], _packed(words)[sl][order])
    # one cluster launch a call where the tile fits the cluster
    assert plan.launches()["cluster_sort"] == 1 + max(t - s, 0)
    if t <= s:
        assert plan.launches() == {"bitonic_stage": 0, "cluster_sort": 1}
    assert plan.launches()["bitonic_stage"] == sum(
        kl - s for kl in range(s + 1, t + 1))
    assert all(0 <= st.code < 1 << 27 for st in plan.steps)
    runs = "".join("|" if st.kind == T.STAGE else "s" for st in plan.steps)
    assert max(len(run) for run in runs.split("|")) <= T.MAX_STEPS


# --- the paths' 2^15-row tile, as one cluster sorts it ----------------------

CLUSTER_ROWS = 256        # tile_rows of the paths' 2^15-row tile


@pytest.fixture(scope="module")
def cluster_tile():
    """One 2^15-row tile whose keys tie across the half- and quarter-tile
    boundaries (rows i, i + 2^13, i + 2^14 and i + 3 * 2^13 share a key:
    the pairs the cross-CTA stages compare), with vals across 2^31."""
    rng = np.random.default_rng(23)
    n = CLUSTER_ROWS * 128
    keys = np.tile(rng.integers(0, 5, n // 4, dtype=np.uint32), 4)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vals[:4] = [0x7FFFFFFF, 0x80000000, 0, 0xFFFFFFFF]
    # a compared word of few values on both sides of 2^31
    v0 = rng.integers(0x7FFFFFFE, 0x80000002, n, dtype=np.uint64).astype(
        np.uint32)
    return keys, vals, v0


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "presorted",
                                  "reversed", "distinct97"])
def test_sort_tiles_cluster_tile_matches_jax(kind):
    # keys alone at the paths' 2^15-row tile (one CTA a tile on the card)
    k = _keys(kind, 2 * CLUSTER_ROWS * 128, np.random.default_rng(24))
    want = np.asarray(J.sort_tiles(jnp.asarray(k), tile_rows=CLUSTER_ROWS))
    got = to_numpy(T.sort_tiles(from_numpy(k), tile_rows=CLUSTER_ROWS))
    np.testing.assert_array_equal(got, want)


def test_sort_tiles_kv_cluster_tile_matches_jax(cluster_tile):
    keys, vals, _ = cluster_tile
    want = _np(J.sort_tiles_kv(jnp.asarray(keys), jnp.asarray(vals),
                               tile_rows=CLUSTER_ROWS))
    got = _port(T.sort_tiles_kv(from_numpy(keys), from_numpy(vals),
                                tile_rows=CLUSTER_ROWS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sort_tiles_multi_cluster_tile_rider_matches_jax(cluster_tile):
    # ncmp = 2 with a rider: (key, v0) compared, with ties; vals ride
    keys, vals, v0 = cluster_tile
    wk, (w0, w1) = J.sort_tiles_multi(
        jnp.asarray(keys), [jnp.asarray(v0), jnp.asarray(vals)],
        tile_rows=CLUSTER_ROWS)
    wk, w0, w1 = np.asarray(wk), np.asarray(w0), np.asarray(w1)
    gk, (g0, g1) = T.sort_tiles_multi(
        from_numpy(keys), [from_numpy(v0), from_numpy(vals)],
        tile_rows=CLUSTER_ROWS)
    gk, g0, g1 = to_numpy(gk), to_numpy(g0), to_numpy(g1)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(g0, w0)
    # riders: the same multiset a tie group, and stable in the port
    assert collections.Counter(zip(gk.tolist(), g0.tolist(), g1.tolist())) \
        == collections.Counter(zip(wk.tolist(), w0.tolist(), w1.tolist()))
    np.testing.assert_array_equal(g1, vals[np.lexsort((v0, keys))])


def test_sort_tiles_multi_cluster_tile_ncmp3_matches_jax(cluster_tile):
    # ncmp = 3, the 64-bit chain's (hi, lo, position)
    keys, _, v0 = cluster_tile
    pos = np.arange(len(keys), dtype=np.uint32)
    wk, wv = J.sort_tiles_multi(jnp.asarray(keys),
                                [jnp.asarray(v0), jnp.asarray(pos)],
                                tile_rows=CLUSTER_ROWS, ncmp=3)
    gk, gv = T.sort_tiles_multi(from_numpy(keys),
                                [from_numpy(v0), from_numpy(pos)],
                                tile_rows=CLUSTER_ROWS, ncmp=3)
    for g, w in zip(_port([gk, *gv]), _np([wk, *wv])):
        np.testing.assert_array_equal(g, w)


# --- the merge design (csrc/tile_sort.cu tile_merge::cluster_sort) ---------
#
# The rider path of sort_tiles_multi (key, payload 0, index word) at the
# 2^15-row tile. The model below runs the kernel's steps on numpy rows:
# each thread's 2^G rows sorted in registers by (key, payload 0, index),
# levels of merge-path merges inside each CTA (a search for the thread's
# first output, then 2^G sequential steps, ties to the left run), then
# the levels across the cluster (each CTA's two cuts found by H-ary
# rounds of probes, its window copied, merged), then the riders gathered
# by the carried index.

def _src_constants():
    import re
    from pathlib import Path
    src = (Path(T.__file__).resolve().parent.parent / "csrc"
           / "tile_sort.cu").read_text()
    m = re.search(r"constexpr int kG = (\d+), kRowsLog2 = (\d+), "
                  r"kCluster = (\d+);", src)
    return tuple(int(x) for x in m.groups())


def _cut(words, lo, mid, hi, d):
    """Rows of run A = words[lo:mid] among the first d of the stable
    merge with B = words[mid:hi] (vectorised over d): the kernel's
    merge-path binary search."""
    a = np.maximum(d - (hi - mid), 0)
    e = np.minimum(d, mid - lo)
    while np.any(a < e):
        on = a < e
        h = (a + e) >> 1
        b_first = (words[np.where(on, mid + d - 1 - h, lo)]
                   < words[np.where(on, lo + h, lo)])
        e = np.where(on & b_first, h, e)
        a = np.where(on & ~b_first, h + 1, a)
    return a


def _cut_rounds(words, lo, w, d, h_probes, rounds):
    """The same cut as csrc `coranks` finds it: each round h_probes evenly
    spaced candidates, the false ones counted."""
    a, e = max(d - w, 0), min(d, w)
    for _ in range(rounds):
        step = (e - a + h_probes - 1) // h_probes
        h = a + np.arange(h_probes) * step
        ok = h < e
        b_row = np.where(ok, lo + w + d - 1 - h, lo)
        a_row = np.where(ok, lo + h, lo)
        before = ok & ~(words[b_row] < words[a_row])
        nf = int(before.sum())
        na = a if nf == 0 else a + (nf - 1) * step + 1
        e = min(e, a + nf * step)
        a = na
    assert a == e
    return a


def _merge_steps(words, carried, mid, hi, d, g):
    """Each thread's 2^g outputs (ranks d..) of the stable merge of
    words[:mid] and words[mid:hi] (vectorised over threads): a search,
    then sequential steps with the read position selected."""
    n = len(words)
    a = _cut(words, 0, mid, hi, d)
    pa, pb = a, mid + d - a
    out_w = np.empty((len(d), 1 << g), words.dtype)
    out_c = np.empty((len(d), 1 << g), carried.dtype)
    for k in range(1 << g):
        ra, rb = words[np.minimum(pa, n - 1)], words[np.minimum(pb, n - 1)]
        take_a = (pb >= hi) | ((pa < mid) & (ra <= rb))
        out_w[:, k] = np.where(take_a, ra, rb)
        out_c[:, k] = np.where(take_a, carried[np.minimum(pa, n - 1)],
                               carried[np.minimum(pb, n - 1)])
        pa, pb = pa + take_a, pb + ~take_a
    return out_w.reshape(-1), out_c.reshape(-1)


def _model_merge_tile(keys, vals, riders, g, rlog, c):
    """One tile of c * 2^rlog rows through tile_merge::cluster_sort's
    steps; returns (keys, vals, riders) as the kernel stores them."""
    e_rows, r_rows = 1 << g, 1 << rlog
    words = keys.astype(np.uint64) << np.uint64(32) | vals.astype(np.uint64)
    index = np.arange(c * r_rows)
    carried = index.copy()
    # registers: each thread's 2^g consecutive rows by (word, index)
    order = np.lexsort((index.reshape(-1, e_rows),
                        words.reshape(-1, e_rows)), axis=-1)
    order += np.arange(0, c * r_rows, e_rows)[:, None]
    words, carried = words[order.reshape(-1)], carried[order.reshape(-1)]
    threads = r_rows >> g
    t0 = np.arange(threads) << g
    for cta in range(c):
        sl = slice(cta * r_rows, (cta + 1) * r_rows)
        w_cta, c_cta = words[sl].copy(), carried[sl].copy()
        w = e_rows
        while w < r_rows:
            lo = t0 & ~(2 * w - 1)
            nw, nc = np.empty_like(w_cta), np.empty_like(c_cta)
            for seg in range(0, r_rows, 2 * w):
                th = lo == seg
                ow, oc = _merge_steps(w_cta[seg:seg + 2 * w],
                                      c_cta[seg:seg + 2 * w], w, 2 * w,
                                      t0[th] - seg, g)
                nw[seg:seg + 2 * w], nc[seg:seg + 2 * w] = ow, oc
            w_cta, c_cta = nw, nc
            w *= 2
        words[sl], carried[sl] = w_cta, c_cta
    # across the cluster: each CTA's window of the two runs, then a merge
    h_probes = threads // 2
    hlog = rlog - g - 1
    clog = c.bit_length() - 1
    rounds = (rlog + clog - 1 + hlog - 1) // hlog
    w = r_rows
    while w < c * r_rows:
        nw, nc = np.empty_like(words), np.empty_like(carried)
        for cta in range(c):
            lo = (cta * r_rows) & ~(2 * w - 1)
            d0 = cta * r_rows - lo
            a0, a1 = (_cut_rounds(words, lo, w, d, h_probes, rounds)
                      for d in (d0, d0 + r_rows))
            assert (a0, a1) == tuple(_cut(words, lo, lo + w, lo + 2 * w,
                                          np.array([d0, d0 + r_rows])))
            rows = np.r_[lo + a0:lo + a1,
                         lo + w + d0 - a0:lo + w + d0 + r_rows - a1]
            ow, oc = _merge_steps(words[rows], carried[rows], a1 - a0,
                                  r_rows, t0, g)
            nw[cta * r_rows:(cta + 1) * r_rows] = ow
            nc[cta * r_rows:(cta + 1) * r_rows] = oc
        words, carried = nw, nc
        w *= 2
    out_k = (words >> np.uint64(32)).astype(np.uint32)
    out_v = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out_k, out_v, [r[carried] for r in riders]


def _model_merge(keys, vals, riders, g, rlog, c):
    tile = c << rlog
    outs = [_model_merge_tile(keys[s:s + tile], vals[s:s + tile],
                              [r[s:s + tile] for r in riders], g, rlog, c)
            for s in range(0, len(keys), tile)]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]),
            [np.concatenate([o[2][k] for o in outs])
             for k in range(len(riders))])


def _merge_data(kind, n, rng):
    if kind == "q1":       # 4 group keys, heavy ties on (key, payload 0)
        return (rng.integers(0, 4, n, dtype=np.uint32),
                rng.integers(0, 3, n, dtype=np.uint32))
    k = _keys(kind, n, rng)
    return k, rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _check_model(keys, vals, riders, geometry):
    got_k, got_v, got_r = _model_merge(keys, vals, riders, *geometry)
    tile_rows = (geometry[2] << geometry[1]) // T.LANES
    wk, wv = T.sort_tiles_multi_plain(from_numpy(keys),
                                      [from_numpy(vals)]
                                      + [from_numpy(r) for r in riders],
                                      tile_rows)
    np.testing.assert_array_equal(got_k, to_numpy(wk))
    for g_, w_ in zip([got_v, *got_r], wv):
        np.testing.assert_array_equal(g_, to_numpy(w_))


def test_merge_design_constants_match_the_source():
    assert _src_constants() == (T.MERGE_G, T.MERGE_ROWS_LOG2,
                                T.MERGE_CLUSTER)
    assert T.MERGE_CLUSTER << T.MERGE_ROWS_LOG2 == 1 << T.MERGE_TILE_LOG2
    # both buffers of rows (8 bytes), indices (2 bytes) and pads fit a CTA
    rows = 1 << T.MERGE_ROWS_LOG2
    slots = rows + (rows >> T.MERGE_G) + 2
    assert slots * 2 * (8 + 2) + 16 <= T.SMEM_LIMIT


@pytest.mark.parametrize("geometry", [(2, 5, 4), (3, 6, 2), (2, 4, 8),
                                      (4, 8, 4)])
@pytest.mark.parametrize("kind", ["uniform", "all_equal", "presorted",
                                  "reversed", "q1", "extremes"])
def test_merge_model_small_geometries(kind, geometry):
    rng = np.random.default_rng(31)
    n = 3 * (geometry[2] << geometry[1])
    keys, vals = _merge_data(kind, n, rng)
    riders = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(3)]
    _check_model(keys, vals, riders, geometry)
    _check_model(keys, vals, riders[:1], geometry)


BUILT = (T.MERGE_G, T.MERGE_ROWS_LOG2, T.MERGE_CLUSTER)


@pytest.mark.parametrize("nriders", [1, 3, 16])
def test_merge_model_cluster_tile(cluster_tile, nriders):
    # the built geometry on the tile whose keys tie across the half- and
    # quarter-tile boundaries (the CTAs' shares), payloads across 2^31
    keys, vals, v0 = cluster_tile
    rng = np.random.default_rng(nriders)
    riders = [vals] + [rng.integers(0, 1 << 32, len(keys), dtype=np.uint64)
                       .astype(np.uint32) for _ in range(nriders - 1)]
    _check_model(keys, v0, riders, BUILT)


@pytest.mark.parametrize("kind", ["all_equal", "presorted", "reversed",
                                  "q1"])
def test_merge_model_built_geometry(kind):
    rng = np.random.default_rng(32)
    keys, vals = _merge_data(kind, 1 << 15, rng)
    riders = [np.arange(1 << 15, dtype=np.uint32)[::-1].copy()]
    _check_model(keys, vals, riders, BUILT)


@pytest.mark.parametrize("span_log2", [4, 9, 13, 14])
def test_merge_cut_rounds_match_binary_search(span_log2):
    # csrc `coranks`: H-ary rounds find the merge-path cut exactly within
    # the round count the kernel computes
    rng = np.random.default_rng(span_log2)
    w = 1 << span_log2
    words = np.sort(rng.integers(0, 50, 2 * w).astype(np.uint64)
                    .reshape(2, w), axis=1).reshape(-1)
    for h_probes, rlog, g in ((256, 13, 4), (4, 5, 2), (2, 4, 2)):
        clog = max(span_log2 + 1 - rlog, 1)
        hlog = h_probes.bit_length() - 1
        rounds = (rlog + clog - 1 + hlog - 1) // hlog
        if span_log2 > rlog + clog - 1:
            continue
        for d in (0, 1, w // 3, w, 2 * w - 1, 2 * w):
            assert (_cut_rounds(words, 0, w, d, h_probes, rounds)
                    == int(_cut(words, 0, w, 2 * w, np.array([d]))[0]))


# which design sorts which call: the wrappers' word lists, as they hand
# them to _sort_words on the card
DESIGNS = [
    ("sort_tiles", 1, 0, 15, "network"),
    ("sort_tiles_kv", 2, 0, 15, "network"),
    ("multi, one payload", 2, 0, 15, "network"),
    ("multi, a rider", 2, 1, 15, "merge"),
    ("multi, three riders", 2, 3, 15, "merge"),
    ("multi, 17 riders", 2, 17, 15, "merge"),
    ("multi ncmp=3", 3, 0, 15, "network"),
    ("multi ncmp=3 + a rider", 3, 1, 15, "network"),
    ("multi, a rider, tile 2^18", 2, 1, 18, "network"),
    ("multi, a rider, tile 2^12", 2, 1, 12, "network"),
]


@pytest.mark.parametrize("what,ncompared,nriders,tile_log2,want", DESIGNS)
def test_design_calls_count_each_path(monkeypatch, what, ncompared,
                                      nriders, tile_log2, want):
    n = 1 << max(tile_log2, 15)
    col = torch.zeros(n, dtype=torch.int32).view(torch.uint32)
    words = [col] * ncompared + ([None] if nriders else [])
    riders = [col] * nriders
    seen = []
    monkeypatch.setattr(T, "_launch_merge", lambda w, dst, r, o:
                        seen.append(("merge", [d is not None for d in dst],
                                     len(r))))
    monkeypatch.setattr(T, "_launch_network", lambda w, dst, r, o, plan, f:
                        seen.append(("network",
                                     [d is not None for d in dst], len(r))))
    designs, kernels = dict(T.DESIGN_CALLS), dict(T.KERNEL_LAUNCHES)
    assert T.design(words, tile_log2) == want
    out_w, out_r = T._sort_words(words, riders, tile_log2, False)
    assert {k: T.DESIGN_CALLS[k] - designs[k] for k in designs} == {
        "network": int(want == "network"), "merge": int(want == "merge")}
    batches = max(1, -(-nriders // T.MAX_RIDERS))
    assert [s[0] for s in seen] == [want] * batches
    assert [s[2] for s in seen] == [min(T.MAX_RIDERS, nriders - i * 16)
                                    for i in range(batches)] or not nriders
    launched = {k: T.KERNEL_LAUNCHES[k] - kernels[k] for k in kernels}
    if want == "merge":
        # one cluster_sort a batch; the compared words stored once, the
        # index word never
        assert launched == {"bitonic_stage": 0, "cluster_sort": batches}
        assert seen[0][1] == [True, True, False]
        assert all(s[1] == [False, False, False] for s in seen[1:])
    else:
        plan = T.tile_plan(len(words), tile_log2, n)
        assert launched == {k: v * batches
                            for k, v in plan.launches().items()}
    assert len(out_w) == ncompared and len(out_r) == nriders


# --- a short last tile ------------------------------------------------------
#
# Any n: the kernels keep the last tile's missing rows (n and after) out of
# device memory and sort them, inside the CTA or cluster, as all-ones
# compared words with their own in-tile indices, the tile's largest, so
# that they land after every row that exists. The models below run each
# design's steps over such a tile and hold its first rows against the
# plain version on the n rows alone.

def _ragged_tile(kind, m, tile, rng):
    """m < tile rows of (key, payload 0): few values, or every row all
    ones (the missing rows' words), with two riders."""
    if kind == "ones":
        keys = np.full(m, 0xFFFFFFFF, np.uint32)
        vals = keys.copy()
        vals[::3] = 0xFFFFFFFE
    else:
        keys, vals = _merge_data(kind, m, rng)
    riders = [rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
              for _ in range(2)]
    return keys, vals, riders


@pytest.mark.parametrize("geometry", [(2, 5, 4), (3, 6, 2), (4, 8, 4)])
@pytest.mark.parametrize("kind", ["q1", "ones", "reversed"])
def test_merge_model_short_last_tile(kind, geometry):
    rng = np.random.default_rng(33)
    tile = geometry[2] << geometry[1]
    for m in (1, tile // 2 - 1, tile // 2 + 1, tile - 1):
        keys, vals, riders = _ragged_tile(kind, m, tile, rng)
        pad = tile - m
        ones = np.full(pad, 0xFFFFFFFF, np.uint32)
        got_k, got_v, got_r = _model_merge_tile(
            np.r_[keys, ones], np.r_[vals, ones],
            [np.r_[r, np.zeros(pad, np.uint32)] for r in riders], *geometry)
        wk, wv = T.sort_tiles_multi_plain(
            from_numpy(keys), [from_numpy(vals)]
            + [from_numpy(r) for r in riders], tile // T.LANES)
        np.testing.assert_array_equal(got_k[:m], to_numpy(wk))
        for g_, w_ in zip([got_v, *got_r], wv):
            np.testing.assert_array_equal(g_[:m], to_numpy(w_))


@pytest.mark.parametrize("nwords,tile_log2", [(1, 9), (2, 8), (3, 16),
                                              (4, 10), (2, 15)])
def test_tile_plan_short_last_tile(nwords, tile_log2):
    # the plan over n rows that end inside a tile covers whole tiles and
    # whole spans (what the kernel checks), and its steps, run over the
    # rows with the missing ones as the largest words (the index word,
    # when last, their own), sort the rows that exist
    t = tile_log2
    tile = 1 << t
    rng = np.random.default_rng(t + nwords)
    for n in (5, 3 * tile + 17, (8 << max(0, 15 - t)) * tile - 1):
        plan = T.tile_plan(nwords, t, n)
        rows = -(-n // tile) * tile
        assert rows % (1 << plan.span_log2) == 0
        for index_last in (False, True):
            words = [rng.integers(0, 8, rows, dtype=np.uint32)
                     for _ in range(nwords - 1)]
            last = (np.arange(rows) % tile if index_last else
                    rng.integers(0, 1 << 32, rows, dtype=np.uint64))
            words.append(last.astype(np.uint32))
            for w in words[:-1]:
                w[n:] = 7
            if not index_last:
                words[-1][n:] = 0xFFFFFFFF
            got, _ = _replay(plan, _packed(words))
            keys = _packed(words)
            for lo in range(0, n, tile):
                hi = min(lo + tile, n)
                np.testing.assert_array_equal(got[lo:hi],
                                              np.sort(keys[lo:hi]))


def _fake_network(words, dst, riders, outs, plan, flip1):
    """The network kernel's contract on CPU tensors: every tile of n rows
    (whole tiles: device-memory stages take no other) sorted by its words
    (a None word the in-tile index), the riders gathered along."""
    n, tile = words[0].shape[0], 1 << plan.tile_log2
    assert n % tile == 0
    index = (torch.arange(n, dtype=torch.int32) % tile).view(torch.uint32)
    out = T._sort_tiles_plain([index if w is None else w for w in words],
                              riders, tile, flip1)
    for d, o in zip([*dst, *outs], out):
        if d is not None:
            d.copy_(o)


@pytest.mark.parametrize("what", ["keys", "kv", "multi, riders"])
@pytest.mark.parametrize("n", [5, (1 << 18) + 5, (2 << 18) - 3])
def test_staged_plans_sort_a_short_last_tile_through_scratch(monkeypatch,
                                                             what, n):
    # a tile above a cluster's span (device-memory stages): the whole tiles
    # sort in place, the short last one through a tile of scratch
    monkeypatch.setattr(T, "_launch_network", _fake_network)
    rng = np.random.default_rng(n)
    col = [from_numpy(rng.integers(0, 5, n, dtype=np.uint32)),
           from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                      .astype(np.uint32))]
    col[0][:7] = 0xFFFFFFFF
    col[1][:3] = 0x7FFFFFFF
    words, riders, flip1 = {
        "keys": ([col[0]], [], False),
        "kv": (col, [], True),
        "multi, riders": ([col[0], None], col, False)}[what]
    t = 18
    assert T.tile_plan(len(words), t, n).launches()["bitonic_stage"] > 0
    out_w, out_r = T._sort_words(words, riders, t, flip1)
    want = T._sort_tiles_plain(
        [w for w in words if w is not None], riders, 1 << t, flip1)
    assert [o.shape[0] for o in (*out_w, *out_r)] == [n] * len(want)
    for g, w in zip([*out_w, *out_r], want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
