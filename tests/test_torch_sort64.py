"""The port's 64-bit sort (lsdradixsort_tpu_torch/ops/sort.py
`sort64_with_ranks` and its single chain, strategy "merge") and the ncmp = 3
mode of its two kernels (kernels/tile_sort.py `sort_tiles_multi`,
kernels/merge.py `merge_pass_multi`), on CPU tensors — the kernels' plain
versions — against the JAX package on the same numpy input.

JAX runs its Pallas kernels in interpret mode at the shrunken geometry of
tests/test_merge.py (tile 2^10, blk=128, buf=2^13). Its "merge" and
"merge2" strategies cost 10-20 s each here, so each runs once; every port
strategy is also held against the JAX "xla" strategy for every dtype and
direction. Outputs are integers and must agree bit for bit.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from lsdradixsort_tpu.kernels import merge as JM
from lsdradixsort_tpu.kernels import tile_sort as JT
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import merge as TM
from lsdradixsort_tpu_torch.kernels import tile_sort as TT

# the ops packages export a function named `sort`: fetch the modules
J = importlib.import_module("lsdradixsort_tpu.ops.sort")
T = importlib.import_module("lsdradixsort_tpu_torch.ops.sort")

TILE_LOG = 10


def _planes(seed, n, dtype):
    """(hi, lo) u32 planes of n 64-bit keys with heavy ties on hi and on
    the whole key; float64 keys include +-0, +-inf and NaN."""
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-5, 5, n)
        x[: n // 4] = np.round(x[: n // 4])
        x[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
        bits = x.view(np.uint64)
    else:
        bits = rng.integers(0, 2**64, n, dtype=np.uint64)
        bits[: n // 2] = (bits[: n // 2] % 7) << np.uint64(32) | (
            bits[: n // 2] % 3)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def _port64(hi, lo, **kw):
    out = T.sort64_with_ranks(from_numpy(hi), from_numpy(lo),
                              tile_log2=TILE_LOG, **kw)
    return [to_numpy(o) for o in out]


@pytest.mark.parametrize("strategy", ["merge", "merge2", "xla"])
@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
@pytest.mark.parametrize("desc", [False, True])
def test_sort64_with_ranks_matches_jax_xla(strategy, dtype, desc):
    n = (1 << 12) - 333                            # ragged: pads sort last
    hi, lo = _planes(70, n, dtype)
    want = J.sort64_with_ranks(jnp.asarray(hi), jnp.asarray(lo), dtype=dtype,
                               descending=desc, strategy="xla")
    got = _port64(hi, lo, dtype=dtype, descending=desc, strategy=strategy)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("strategy,dtype", [("merge", "uint64"),
                                            ("merge2", "int64")])
def test_sort64_with_ranks_matches_jax_merge_engine(strategy, dtype):
    # the JAX package's own merge engines (interpret mode), once each
    n = 1 << 12
    hi, lo = _planes(71, n, dtype)
    want = J.sort64_with_ranks(jnp.asarray(hi), jnp.asarray(lo), dtype=dtype,
                               strategy=strategy, tile_log2=TILE_LOG)
    got = _port64(hi, lo, dtype=dtype, strategy=strategy)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    if dtype == "int64":
        key = key.view(np.int64)
    np.testing.assert_array_equal(got[2], np.argsort(key, kind="stable"))


def test_merge1_sort64_counts_ncmp3_passes():
    # one tile sort and ceil(log8(tiles)) merge passes, all at ncmp = 3,
    # on the plain versions for CPU tensors
    hi, lo = _planes(72, 1 << 13, "uint64")
    before = (dict(TT.PLAIN_CALLS), dict(TM.PLAIN_CALLS))
    h, lw, pos = T.sort64_with_ranks(from_numpy(hi), from_numpy(lo),
                                     strategy="merge", tile_log2=TILE_LOG)
    assert TT.PLAIN_CALLS["sort_tiles_multi"] == \
        before[0]["sort_tiles_multi"] + 1
    assert TM.PLAIN_CALLS["merge_pass_multi"] == \
        before[1]["merge_pass_multi"] + 1
    order = np.lexsort((lo, hi))
    np.testing.assert_array_equal(to_numpy(pos), order)
    np.testing.assert_array_equal(to_numpy(h), hi[order])
    np.testing.assert_array_equal(to_numpy(lw), lo[order])


@pytest.mark.parametrize("rider", [False, True])
def test_sort_tiles_multi_ncmp3_matches_jax(rider):
    # (hi, lo, position) compared; a rider follows its row
    rng = np.random.default_rng(73)
    n = 4 * 8 * 128
    hi = rng.integers(0, 3, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo[: n // 2] %= 2
    pos = rng.permutation(n).astype(np.uint32)
    vals = [lo, pos] + ([rng.integers(0, 2**32, n, dtype=np.uint64)
                         .astype(np.uint32)] if rider else [])
    wk, wv = JT.sort_tiles_multi(jnp.asarray(hi),
                                 [jnp.asarray(v) for v in vals],
                                 tile_rows=8, ncmp=3)
    gk, gv = TT.sort_tiles_multi(from_numpy(hi), [from_numpy(v) for v in vals],
                                 tile_rows=8, ncmp=3)
    for g, w in zip([gk, *gv], [wk, *wv], strict=True):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("nruns", [8, 4])
def test_merge_pass_multi_ncmp3_matches_jax(nruns):
    # runs sorted by (hi, lo, position); the JAX tables split ties on the
    # (hi, lo) pair (merge_pass_tables keys2=)
    rng = np.random.default_rng(74 + nruns)
    L = 1 << 10
    n = nruns * L
    hi = rng.integers(0, 4, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo[::3] %= 5
    pos = np.arange(n, dtype=np.uint32)
    rider = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cols = [hi, lo, pos, rider]
    for r in range(nruns):
        s = slice(r * L, (r + 1) * L)
        o = np.lexsort((pos[s], lo[s], hi[s]))
        for c in cols:
            c[s] = c[s][o]
    buf = JM.pass_buf_elems(L, 1 << 13)
    tab, ok = JM.merge_pass_tables(jnp.asarray(hi), L, buf, 128,
                                   keys2=jnp.asarray(lo))
    assert bool(ok)
    wk, wv = JM.merge_pass_multi(jnp.asarray(hi),
                                 [jnp.asarray(c) for c in cols[1:]], tab,
                                 run_len=L, buf_elems=buf, blk=128, ncmp=3)
    gk, gv = TM.merge_pass_multi(from_numpy(hi),
                                 [from_numpy(c) for c in cols[1:]], L, ncmp=3)
    for g, w in zip([gk, *gv], [wk, *wv], strict=True):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(to_numpy(gv[1]),
                                  pos[np.lexsort((pos, lo, hi))])


def test_sort64_invalid_inputs_raise():
    x = from_numpy(np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError):
        T.sort64_with_ranks(x, x, strategy="composed")
    with pytest.raises(TypeError):
        T.sort64_with_ranks(x, x, dtype="float32")
