"""The port's chip-scale chunked sort (lsdradixsort_tpu_torch/ops/bigsort.py,
kernels/merge.py `merge_tables_exact_runs` and `merge_pass_runs`) on CPU
tensors — the plain version of the merge_pass_runs kernel — against the
JAX package on the same numpy input, and against the stable golden order
(np.lexsort) where the JAX package is costly or crashes.

Shrunken geometry as tests/test_bigsort.py: runs of 2^11-2^12, chunks of
2^10 rows, blk=128 (the JAX side also buf_elems=2^13). The JAX tables
are jnp only; its chunked merge runs Pallas in interpret mode (10-30 s a
call here), so two such calls, shared through module-scoped fixtures,
are the JAX references. Outputs are integers and must agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import merge as JM
from lsdradixsort_tpu.ops import bigsort as JB
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import merge as TM
from lsdradixsort_tpu_torch.ops import bigsort as TB

BLK = 128
BUF = 1 << 13
C_LOG = 10
TILE_LOG = 10


def _sorted_runs(rng, S, L, maxval=2**32):
    """S sorted key runs and the global positions, laid out run-major."""
    ks = [np.sort(rng.integers(0, maxval, L, dtype=np.uint64)
                  .astype(np.uint32)) for _ in range(S)]
    vs = [np.arange(s * L, (s + 1) * L, dtype=np.uint32) for s in range(S)]
    return ks, vs


def _port_chunked(ks, vs, **kw):
    outs = TB.merge_runs_chunked(
        [[from_numpy(k) for k in ks], [from_numpy(v) for v in vs]],
        chunk_log2=C_LOG, blk=BLK, buf_elems=BUF, **kw)
    return [np.concatenate([to_numpy(r) for r in o]) for o in outs]


def _golden(ks, vs):
    allk, allv = np.concatenate(ks), np.concatenate(vs)
    order = np.lexsort((allv, allk))
    return allk[order], allv[order]


TABLE_DISTS = ("uniform", "allequal", "clustered", "tinyrange", "extremes")


def _table_keys(rng, dist, S, Ls):
    ks = []
    for _ in range(S):
        if dist == "uniform":
            k = rng.integers(0, 2**32, Ls, dtype=np.uint64).astype(np.uint32)
        elif dist == "allequal":
            k = np.full(Ls, 0xDEADBEEF, np.uint32)
        elif dist == "clustered":
            k = (rng.integers(0, 3, Ls) * 0x40000000
                 + rng.integers(0, 4, Ls)).astype(np.uint32)
        elif dist == "tinyrange":
            k = rng.integers(1000, 1010, Ls, dtype=np.uint32)
        else:  # extremes: 0 and 0xFFFFFFFF only
            k = np.where(rng.integers(0, 2, Ls) == 0, 0,
                         0xFFFFFFFF).astype(np.uint32)
        ks.append(np.sort(k))
    return ks


@pytest.mark.parametrize("fanout", [None, 3, 16, 256])
@pytest.mark.parametrize("dist", TABLE_DISTS)
def test_exact_tables_match_jax(fanout, dist):
    # the five key families of tests/test_bigsort.py:135-173; the JAX
    # table is jnp only (no Pallas), so it runs as XLA on the CPU
    rng = np.random.default_rng(50 + TABLE_DISTS.index(dist))
    S, Ls, C = 4, 1 << 9, 1 << 8
    ks = _table_keys(rng, dist, S, Ls)
    wt, wm = jax.jit(lambda rk: JM.merge_tables_exact_runs(
        rk, chunk_elems=C, blk=BLK, fanout=fanout))(
            [jnp.asarray(k) for k in ks])
    gt, gm = TM.merge_tables_exact_runs([from_numpy(k) for k in ks], C,
                                        blk=BLK, fanout=fanout)
    assert gt.dtype == torch.int32 and gt.shape == wt.shape
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert int(gm) == int(wm)
    # every chunk starts at exactly t * C (tests/test_bigsort.py:171-173)
    tab = gt.numpy()
    nch = S * Ls // C
    starts = tab[:nch, :8].sum(axis=1) * 128 + tab[:nch, 17] * 128 \
        - tab[:nch, 16]
    np.testing.assert_array_equal(starts, np.arange(nch) * C)


@pytest.mark.parametrize("S", [8, 2])
def test_exact_tables_eight_and_two_runs_match_jax(S):
    # a full 8-slot table and one padded from 2 runs, at blk = 2^9
    rng = np.random.default_rng(56 + S)
    ks, _ = _sorted_runs(rng, S, 1 << 11, maxval=1 << 12)
    wt, _ = jax.jit(lambda rk: JM.merge_tables_exact_runs(
        rk, chunk_elems=1 << 10, blk=1 << 9, rounds=7, fanout=16))(
            [jnp.asarray(k) for k in ks])
    gt, _ = TM.merge_tables_exact_runs([from_numpy(k) for k in ks], 1 << 10,
                                       blk=1 << 9, fanout=16, rounds=7)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.fixture(scope="module")
def merge_case():
    """S = 4 runs of 2^11 with heavy duplicates, and the JAX chunked
    merge of them (interpret mode, 2 ranges)."""
    rng = np.random.default_rng(60)
    ks, vs = _sorted_runs(rng, 4, 1 << 11, maxval=700)
    outs = JB.merge_runs_chunked(
        [[jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in vs]],
        chunk_log2=C_LOG, nranges=2, blk=BLK, buf_elems=BUF)
    want = [np.concatenate([np.asarray(r) for r in o]) for o in outs]
    return ks, vs, want


@pytest.mark.parametrize("nranges,fanout", [(2, None), (1, None), (4, None),
                                            (8, None), (2, 3), (4, 16)])
def test_merge_runs_chunked_matches_jax(merge_case, nranges, fanout):
    ks, vs, want = merge_case
    got = _port_chunked(ks, vs, nranges=nranges, fanout=fanout)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], _golden(ks, vs)[0])


@pytest.mark.parametrize("trim", [True, False])
def test_merge_runs_chunked_trims_and_launch_count(merge_case, trim):
    # one merge_pass_runs call a range, on buffers that the trims leave of
    # different lengths; the output does not depend on the trims
    ks, vs, want = merge_case
    seen = []
    real = TM.merge_pass_runs

    def spy(run_streams, tables, **kw):
        seen.append([int(r.shape[0]) for r in run_streams[0]])
        return real(run_streams, tables, **kw)

    plain = TM.PLAIN_CALLS["merge_pass_runs"]
    TM.merge_pass_runs = spy
    try:
        got = _port_chunked(ks, vs, nranges=4, trim=trim)
    finally:
        TM.merge_pass_runs = real
    assert TM.PLAIN_CALLS["merge_pass_runs"] == plain + 4
    assert len(seen) == 4 and seen[0] == [1 << 11] * 4
    if trim:
        assert len(set(map(tuple, seen))) > 1 and min(seen[-1]) < 1 << 11
    else:
        assert seen == [[1 << 11] * 4] * 4
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def sort_kv_case():
    """S = 4 segments of 2^11 keys in [0, 500) with a full-range payload,
    and the JAX package's sort_kv_chunked of them (interpret mode)."""
    rng = np.random.default_rng(61)
    S, L = 4, 1 << 11
    segs = [rng.integers(0, 500, L, dtype=np.uint32) for _ in range(S)]
    vals = [rng.integers(0, 2**32, L, dtype=np.uint64).astype(np.uint32)
            for _ in range(S)]
    outs = JB.sort_kv_chunked(
        [jnp.asarray(s) for s in segs], [jnp.asarray(v) for v in vals],
        tile_log2=TILE_LOG, chunk_log2=C_LOG, nranges=2, blk=BLK,
        buf_elems=BUF)
    want = [np.concatenate([np.asarray(r) for r in o]) for o in outs]
    return segs, vals, want


@pytest.mark.parametrize("payload", [True, False])
def test_sort_kv_chunked_matches_jax(sort_kv_case, payload):
    segs, vals, want = sort_kv_case
    ksegs = [from_numpy(s) for s in segs]
    vsegs = [from_numpy(v) for v in vals] if payload else None
    if payload:
        outs = TB.sort_kv_chunked(ksegs, vsegs, tile_log2=TILE_LOG,
                                  chunk_log2=C_LOG, nranges=2, blk=BLK,
                                  buf_elems=BUF)
    else:
        outs = TB.sort_with_ranks_chunked(ksegs, tile_log2=TILE_LOG,
                                          chunk_log2=C_LOG, nranges=2,
                                          blk=BLK, buf_elems=BUF)
    assert ksegs == [] and (vsegs is None or vsegs == [])   # consumed
    got = [np.concatenate([to_numpy(r) for r in o]) for o in outs]
    assert len(got) == (3 if payload else 2)
    for g, w in zip(got, want[:len(got)], strict=True):
        np.testing.assert_array_equal(g, w)
    perm = np.argsort(np.concatenate(segs), kind="stable")
    np.testing.assert_array_equal(got[1], perm.astype(np.uint32))


def test_merge_runs_chunked_skewed_goes_through_the_kernel(rng):
    # the adversarial layout of tests/test_bigsort.py:64-83: run s holds
    # keys near s * 2^28, so every chunk draws its whole mass from one
    # run (what the JAX package's overflow check guards; the port's
    # kernel has no capacity and no fallback)
    S, L = 8, 1 << 12
    ks, vs = [], []
    for s in range(S):
        lo = s * (2 ** 28)
        ks.append(np.sort(rng.integers(lo, lo + 1000, L).astype(np.uint32)))
        vs.append(np.arange(s * L, (s + 1) * L, dtype=np.uint32))
    plain = TM.PLAIN_CALLS["merge_pass_runs"]
    got = _port_chunked(ks, vs, nranges=2)
    assert TM.PLAIN_CALLS["merge_pass_runs"] == plain + 2
    for g, w in zip(got, _golden(ks, vs), strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("blk,nranges", [(512, 2), (1024, 4)])
def test_merge_runs_chunked_short_runs(rng, blk, nranges):
    # runs shorter than one chunk plus two table blocks (C + 2 blk), where
    # the JAX fallback crashes (ROADMAP Queue C 1): held against the
    # golden order only, with every chunk drawn from one run (skew) too
    S, L = 8, 1 << 10
    ks = [np.sort(rng.integers(s * 2**28, s * 2**28 + 50, L)
                  .astype(np.uint32)) for s in range(S)]
    vs = [np.arange(s * L, (s + 1) * L, dtype=np.uint32) for s in range(S)]
    outs = TB.merge_runs_chunked(
        [[from_numpy(k) for k in ks], [from_numpy(v) for v in vs]],
        chunk_log2=C_LOG, nranges=nranges, blk=blk, buf_elems=BUF)
    got = [np.concatenate([to_numpy(r) for r in o]) for o in outs]
    for g, w in zip(got, _golden(ks, vs), strict=True):
        np.testing.assert_array_equal(g, w)


def test_merge_runs_chunked_rider_and_consumer(rng):
    # a riding third stream; range_consumer receives each range, its
    # results replace the ranges, and consume_inputs clears the lists
    S, L = 4, 1 << 11
    ks, vs = _sorted_runs(rng, S, L, maxval=40)
    rs = [rng.integers(0, 2**32, L, dtype=np.uint64).astype(np.uint32)
          for _ in range(S)]
    streams = [[from_numpy(x) for x in col] for col in (ks, vs, rs)]
    seen = []

    def consume(ri, outs):
        assert ri == len(seen) and len(outs) == 3
        seen.append([to_numpy(o) for o in outs])
        return ri * 10

    out = TB.merge_runs_chunked(streams, chunk_log2=C_LOG, nranges=2,
                                blk=BLK, buf_elems=BUF,
                                range_consumer=consume, consume_inputs=True)
    assert out == [[0, 10], [], []]
    assert streams == [[], [], []]
    allk, allv, allr = (np.concatenate(c) for c in (ks, vs, rs))
    order = np.lexsort((allv, allk))
    for i, col in enumerate((allk, allv, allr)):
        np.testing.assert_array_equal(
            np.concatenate([s[i] for s in seen]), col[order])


def test_merge_pass_runs_plain_trimmed_ncmp3(rng):
    # the kernel's plain version on its own: runs of different lengths, a
    # range in the middle, three compared streams (key, val0, val1)
    lens = [3000, 1024, 4096]
    ks, v0, v1 = [], [], []
    for ln in lens:
        k = rng.integers(0, 3, ln, dtype=np.uint32)
        a = rng.integers(0, 3, ln, dtype=np.uint32)
        b = rng.integers(0, 2**32, ln, dtype=np.uint64).astype(np.uint32)
        o = np.lexsort((b, a, k))
        ks.append(k[o]), v0.append(a[o]), v1.append(b[o])
    tab = torch.zeros((16, TM.NCOLS), dtype=torch.int32)
    # chunk 0 = ranks [1280, 1280 + 3 * 1024): windows the whole runs
    tab[0, 8:11] = torch.tensor([(ln + BLK - 1) // BLK for ln in lens])
    tab[0, 17], tab[0, 16] = 10, 0
    streams = [[from_numpy(x) for x in col] for col in (ks, v0, v1)]
    got = TM.merge_pass_runs(streams, tab, chunk0=0, nchunks=3,
                             chunk_elems=1024, buf_elems=BUF, blk=BLK,
                             ncmp=3)
    allc = [np.concatenate(c) for c in (ks, v0, v1)]
    order = np.lexsort((allc[2], allc[1], allc[0]))[1280:1280 + 3072]
    for g, c in zip(got, allc, strict=True):
        np.testing.assert_array_equal(to_numpy(g), c[order])


def test_merge_pass_runs_invalid_inputs_raise():
    k = torch.zeros(1024, dtype=torch.int32).view(torch.uint32)
    tab = torch.zeros((16, TM.NCOLS), dtype=torch.int32)
    kw = dict(chunk0=0, nchunks=1, chunk_elems=1024, buf_elems=BUF, blk=BLK)
    with pytest.raises(ValueError):
        TM.merge_pass_runs([[k] * 9, [k] * 9], tab, **kw)        # 9 runs
    with pytest.raises(ValueError):
        TM.merge_pass_runs([[k, k], [k, k[:512]]], tab, **kw)    # lengths
    with pytest.raises(ValueError):
        TM.merge_pass_runs([[k, k]], tab, ncmp=2, **kw)          # ncmp > ns
    with pytest.raises(ValueError):                              # past end
        TM.merge_pass_runs([[k, k]], tab, **{**kw, "nchunks": 3})
    with pytest.raises(ValueError):
        TB.merge_runs_chunked([[k], [k]], chunk_log2=C_LOG)       # S = 1
    with pytest.raises(ValueError):
        TB.merge_runs_chunked([[k] * 3, [k] * 3], chunk_log2=C_LOG,
                              nranges=2)                          # 3 chunks
