"""The merge engine on n rows that are not a power-of-two count of whole
tiles (lsdradixsort_tpu_torch/ops/sort.py `_merge_chain`: a short last
tile, a short last run in each merge pass, nothing padded), on CPU
tensors — the plain versions the card's kernels are held against — and
the plain merge pass and partition on a short last run.

The JAX package pads to a power-of-two tile count and sorts stably; its
"xla" strategy gives the same orders without interpreting the Pallas
kernels at these sizes, so each port op is held bit for bit against the
permutations the JAX package's `sort_lex` returns, at the small tile
geometry of tests/test_torch_sort.py (2^10 rows)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core import profiling
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import merge as M

J = importlib.import_module("lsdradixsort_tpu.ops.sort")
T = importlib.import_module("lsdradixsort_tpu_torch.ops.sort")

TILE_LOG = 10
TILE = 1 << TILE_LOG
GEOM = dict(tile_log2=TILE_LOG, max_buf=1 << 13, blk=128)
# one row; a tile less one; one row past a tile; a short tile after
# three; a last group of one one-row run; a short run in a short group;
# a short last run after a whole group of groups
NS = [1, TILE - 1, TILE + 1, 3 * TILE + 5, 8 * TILE + 1, 9 * TILE - 3,
      64 * TILE + 7]
KINDS = ["ties", "all_equal", "all_ones"]


def _columns(kind, n):
    """(key, payload 0, rider) as numpy u32: keys tied in few values with
    payload 0 across 2^31, every key equal, or every key and payload 0
    all ones (the rows the chain once padded with)."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, 7, n, dtype=np.uint32)
    v0 = rng.integers(0x7FFFFFF0, 0x80000010, n, dtype=np.uint64).astype(
        np.uint32)
    if kind == "all_equal":
        k[:] = 0xDEADBEEF
    elif kind == "all_ones":
        k[:] = v0[:] = 0xFFFFFFFF
    rider = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return k, v0, rider


def _jax_perm(cols):
    """The JAX package's stable lexicographic order of the columns."""
    _, perm = J.sort_lex([jnp.asarray(c) for c in cols], strategy="xla")
    return np.asarray(perm)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
def test_chain_sorts_n_rows_as_the_jax_package(n, kind):
    k, v0, rider = _columns(kind, n)
    by_key, by_pair = _jax_perm([k]), _jax_perm([k, v0])
    t = [from_numpy(c) for c in (k, v0, rider)]
    before = profiling.counts()

    def same(got, want):
        np.testing.assert_array_equal(to_numpy(got), want)

    # tiles "keys": one word
    same(T.merge_sort_keys(t[0], **GEOM), k[by_key])
    # tiles "kv": the key and the position, compared signed
    sk, pos = T.merge_sort_with_ranks(t[0], **GEOM)
    same(sk, k[by_key])
    same(pos, by_key.astype(np.uint32))
    # tiles "multi" at ncmp 1 and 2: (key, payload 0), a rider along
    same(T.merge_sort_multi(t[0], [], **GEOM)[0], k[by_key])
    sk, (s0, s1) = T.merge_sort_multi(t[0], [t[1], t[2]], **GEOM)
    for got, col in zip((sk, s0, s1), (k, v0, rider)):
        same(got, col[by_pair])
    # sort_kv and sort_lex: the chain's position word and riders
    sk, (s0, s1) = T.sort_kv(t[0], [t[1], t[2]], tile_log2=TILE_LOG)
    for got, col in zip((sk, s0, s1), (k, v0, rider)):
        same(got, col[by_key])
    (sk, s0), perm = T.sort_lex([t[0], t[1]], tile_log2=TILE_LOG)
    same(sk, k[by_pair])
    same(s0, v0[by_pair])
    same(perm, by_pair.astype(np.uint32))
    # tiles "multi" at ncmp 3: (hi, lo, position) of 64-bit keys
    hi, lo, perm = T.sort64_with_ranks(t[0], t[1], tile_log2=TILE_LOG)
    same(hi, k[by_pair])
    same(lo, v0[by_pair])
    same(perm, by_pair.astype(np.uint32))
    # eight chain calls, each of n rows that are no power-of-two count of
    # whole tiles; no value read on the host
    got = {c: profiling.COUNTS[c] - before[c] for c in before}
    assert got["ragged_sorts"] == 8
    assert got["host_syncs"] == 0


@pytest.mark.parametrize("n", [TILE, 4 * TILE])
def test_whole_power_of_two_tiles_count_no_ragged_sort(n):
    k, _, _ = _columns("ties", n)
    before = profiling.COUNTS["ragged_sorts"]
    np.testing.assert_array_equal(
        to_numpy(T.merge_sort_keys(from_numpy(k), **GEOM)), np.sort(k))
    assert profiling.COUNTS["ragged_sorts"] == before


# --- the plain merge pass and partition on a short last run ---------------

RUN = 1000


def _short_runs(ncmp, nruns, last, seed):
    """ncmp compared columns and a rider of (nruns - 1) * RUN + last rows,
    each run of RUN rows (the last of `last`) sorted on the compared
    words."""
    rng = np.random.default_rng(seed)
    n = (nruns - 1) * RUN + last
    cols = [rng.integers(0, 3, n, dtype=np.uint32)] + [
        rng.integers(0, 2, n, dtype=np.uint32) for _ in range(ncmp - 1)]
    cols.append(np.arange(n, dtype=np.uint32)[::-1].copy())
    for lo in range(0, n, RUN):
        s = slice(lo, lo + RUN)
        order = np.lexsort(tuple(c[s] for c in reversed(cols[:ncmp])))
        for c in cols:
            c[s] = c[s][order]
    return cols


# (runs, rows of the last): a one-row last run in a group of 8, a last
# group of one one-row run, a short run ending a short group of 3
SHORT = [(8, 1), (9, 1), (11, 517)]


@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("nruns,last", SHORT)
def test_plain_merge_pass_on_a_short_last_run(nruns, last, ncmp):
    cols = _short_runs(ncmp, nruns, last, seed=nruns * 4 + ncmp)
    n = cols[0].shape[0]
    k, vs = M.merge_pass_multi(from_numpy(cols[0]),
                               [from_numpy(c) for c in cols[1:]], RUN, ncmp)
    got = [to_numpy(x) for x in (k, *vs)]
    for g0 in range(0, n, M.KWAY * RUN):
        s = slice(g0, min(g0 + M.KWAY * RUN, n))
        order = np.lexsort(tuple(c[s] for c in reversed(cols[:ncmp])))
        for g, c in zip(got, cols, strict=True):
            np.testing.assert_array_equal(g[s], c[s][order])


@pytest.mark.parametrize("ncmp", [1, 2, 3])
@pytest.mark.parametrize("nruns,last", SHORT)
def test_plain_partition_on_a_short_last_run(nruns, last, ncmp):
    # every output tile's co-ranks, read off a stable sort of each group:
    # the rows of each run (the last short) before the tile's first row
    cols = _short_runs(ncmp, nruns, last, seed=nruns * 5 + ncmp)
    n = cols[0].shape[0]
    got = M.merge_path_splits(from_numpy(cols[0]),
                              [from_numpy(c) for c in cols[1:]], RUN, ncmp)
    want = []
    for g0 in range(0, n, M.KWAY * RUN):
        s = slice(g0, min(g0 + M.KWAY * RUN, n))
        order = np.lexsort((np.arange(s.stop - g0),
                            *(c[s] for c in reversed(cols[:ncmp]))))
        run = order // RUN
        want += [np.bincount(run[:r], minlength=M.KWAY)
                 for r in range(0, s.stop - g0, M.TILE)]
    assert got.shape == (M.tile_plan(n, RUN)[1], M.KWAY)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("n,run_len,plan", [
    (8 * RUN + 1, RUN, (2, 3)),       # a last group of one one-row run
    (11 * RUN - 483, RUN, (2, 3)),    # a short run ending a group of 3
    (5 * M.TILE - 1, M.TILE, (5, 5)),  # one group, its last run short
])
def test_tile_plan_on_a_short_last_run(n, run_len, plan):
    assert M.tile_plan(n, run_len) == plan


def test_sorts_of_a_short_tile_allocate_no_padding(monkeypatch):
    # the chain hands every kernel wrapper n rows a stream
    seen = []
    real = M.merge_pass_multi

    def spy(keys, vals, run_len, ncmp=None):
        seen.append((keys.shape[0], *(v.shape[0] for v in vals)))
        return real(keys, vals, run_len, ncmp)

    monkeypatch.setattr(T, "merge_pass_multi", spy)
    n = 9 * TILE - 3
    k, v0, rider = (from_numpy(c) for c in _columns("ties", n))
    T.merge_sort_multi(k, [v0, rider], **GEOM)
    assert seen == [(n, n, n)] * 2
    assert torch.equal(k, from_numpy(_columns("ties", n)[0]))
