"""The reduction after the sort of a filtered GROUP BY SUM
(lsdradixsort_tpu_torch/kernels/aggregate.py `filtered_run_sums`) on CPU
tensors -- the plain PyTorch version -- against the JAX package's
`filtered_group_by_sum`, on the same numpy input, bit for bit on the
first count rows; a model of the CUDA kernel's tiles and look-back
against the plain version; the wrapper's checks, counters and constants.

The JAX op runs below 2^15 rows, where its compaction is a sort and
compiles in well under a second."""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import aggregate as AG

JA = importlib.import_module("lsdradixsort_tpu.ops.aggregate")

T = AG.TILE_ROWS
RAGGED = 3 * T + 77


def _case(name):
    """(keys, group keys, values, lo, hi) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = {"below the tile": 1000, "distinct groups": 2 * T + 3}.get(name,
                                                                  RAGGED)
    keys = rng.integers(0, 100, n).astype(np.uint32)
    gk = rng.integers(0, 4, n).astype(np.uint32)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    lo, hi = 0, 98                   # about 98 % kept, as in Q1
    if name == "every row rejected":
        lo = hi = 50
    elif name == "one group":
        gk[:] = 7
    elif name == "sentinel group":   # a real group 0xFFFFFFFF
        gk[rng.random(n) < 0.3] = 0xFFFFFFFF
        lo, hi = 20, 80
    elif name == "sums wrap":
        vals = rng.integers(1 << 31, 1 << 32, n, dtype=np.uint64
                            ).astype(np.uint32)
    elif name == "distinct groups":
        gk = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return keys, gk, vals, np.uint32(lo), np.uint32(hi)


def _sorted_streams(keys, gk, vals, lo, hi):
    """The three streams filtered_group_by_sum hands the reduction: group
    key (0xFFFFFFFF where rejected) and (rejected << 31) | position, sorted
    by both, with the values along."""
    keep = (keys >= lo) & (keys < hi)
    g = np.where(keep, gk, np.uint32(0xFFFFFFFF))
    packed = (np.where(keep, 0, 1 << 31)
              | np.arange(keys.shape[0])).astype(np.uint32)
    order = np.lexsort((packed, g))
    return g[order], packed[order], vals[order]


CASES = ["below the tile", "ragged, runs across tiles", "every row rejected",
         "one group", "sentinel group", "sums wrap", "distinct groups"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    keys, gk, vals, lo, hi = _case(name)
    count, uk, sums = JA.filtered_group_by_sum(
        jnp.asarray(keys), jnp.asarray(gk), jnp.asarray(vals), lo, hi)
    c = int(count)
    got = AG.filtered_run_sums(*map(from_numpy,
                                    _sorted_streams(keys, gk, vals, lo, hi)))
    assert got[0].dtype == torch.uint32 and got[0].dim() == 0
    assert int(got[0]) == c
    for g, w in zip(got[1:], (uk, sums)):
        assert g.dtype == torch.uint32 and g.shape == (keys.shape[0],)
        np.testing.assert_array_equal(to_numpy(g)[:c], np.asarray(w)[:c])
    keep = (keys >= lo) & (keys < hi)
    assert c == np.unique(gk[keep]).size
    if name == "every row rejected":
        assert c == 0
    if name == "sentinel group":
        assert to_numpy(got[1])[c - 1] == 0xFFFFFFFF
    if name == "sums wrap":
        assert np.asarray(sums, np.uint64)[:c].sum() < vals[keep].astype(
            np.uint64).sum()


def _model(sk, sp, sv, tile):
    """The CUDA kernel's arithmetic in numpy: each tile's pair (run ends,
    the sum after its last), the pairs before it combined in order as the
    look-back combines them, and each run end's output row and sum from
    the pair before it."""
    n = sk.shape[0]
    kept = sp.astype(np.int64) < (1 << 31)
    v = np.where(kept, sv, 0).astype(np.uint64)
    nxt_k = np.append(sk[1:], 0)
    nxt_kept = np.append(kept[1:], False)
    last_row = np.arange(n) == n - 1
    end = kept & (last_row | (nxt_k != sk) | (nxt_kept != kept))

    def combine(a, b):
        return (a[0] + b[0], b[1] if b[0] else (a[1] + b[1]) % (1 << 32))

    pairs = []
    for t0 in range(0, n, tile):
        c, s = 0, 0
        for i in range(t0, min(t0 + tile, n)):
            s = (s + int(v[i])) % (1 << 32)
            if end[i]:
                c, s = c + 1, 0
        pairs.append((c, s))
    keys_out, sums_out = [], []
    before = (0, 0)
    for t, t0 in enumerate(range(0, n, tile)):
        c, s = before
        for i in range(t0, min(t0 + tile, n)):
            s = (s + int(v[i])) % (1 << 32)
            if end[i]:
                keys_out.append(sk[i])
                sums_out.append(s)
                assert len(keys_out) == c + 1
                c, s = c + 1, 0
        before = combine(before, pairs[t])
    return before[0], np.array(keys_out, np.uint32), np.array(sums_out,
                                                              np.uint32)


@pytest.mark.parametrize("name", ["ragged, runs across tiles",
                                  "sentinel group", "every row rejected"])
def test_kernel_model_matches_plain(name):
    streams = _sorted_streams(*_case(name))
    count, uk, sums = AG.filtered_run_sums_plain(*map(from_numpy, streams))
    c = int(count)
    for tile in (T, 1000, 7):
        mc, muk, msums = _model(*streams, tile)
        assert mc == c
        np.testing.assert_array_equal(muk, to_numpy(uk)[:c])
        np.testing.assert_array_equal(msums, to_numpy(sums)[:c])


def test_input_checks_raise():
    x = from_numpy(np.zeros(64, np.uint32))
    with pytest.raises(ValueError, match="uint32"):
        AG.filtered_run_sums(x, x, x.view(torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        AG.filtered_run_sums(x, x[:-1], x)
    with pytest.raises(ValueError, match="uint32"):
        AG.filtered_run_sums(x.view(1, -1)[0:1], x, x)
    with pytest.raises(ValueError, match="uint32"):
        AG.filtered_run_sums(x, torch.zeros(64, dtype=torch.int64), x)


def test_counters_count_plain_calls_on_cpu():
    launches, plain = dict(AG.LAUNCHES), dict(AG.PLAIN_CALLS)
    streams = [from_numpy(s) for s in
               _sorted_streams(*_case("below the tile"))]
    AG.filtered_run_sums(*streams)
    AG.filtered_run_sums_plain(*streams)
    assert AG.LAUNCHES == launches
    assert AG.PLAIN_CALLS["filtered_run_sums"] == (
        plain["filtered_run_sums"] + 2)


def test_tile_matches_the_source():
    # the wrapper sizes the look-back scratch from its own copy of
    # csrc/aggregate.cu's tile
    src = (Path(AG.__file__).resolve().parent.parent / "csrc"
           / "aggregate.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] == AG.CTA_THREADS
    assert consts["kRows"] == AG.ROWS
    assert "kTile = kThreads * kRows;" in src
    assert AG.TILE_ROWS == AG.CTA_THREADS * AG.ROWS
