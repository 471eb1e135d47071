"""The port's multi-column sort, window ranks and block sort
(lsdradixsort_tpu_torch/ops/sort.py `sort_lex`, `sort_blocks_kv`;
ops/window.py `window_rank`) on CPU tensors — the kernels' plain versions
— against the JAX package on the same numpy input.

The JAX references use strategy "xla" (exact, and a second or less here;
its merge engine costs 15 s a call in interpret mode) except for one
two-column `sort_lex` on the JAX merge engine; `window_rank` and
`sort_blocks_kv` reach the JAX package's Pallas fill-forward and tile
sort in interpret mode. Outputs are integers and must agree bit for bit.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from lsdradixsort_tpu.ops.window import window_rank as j_window_rank
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import fill_forward as TF
from lsdradixsort_tpu_torch.kernels import merge as TM
from lsdradixsort_tpu_torch.ops.window import window_rank

# the ops packages export a function named `sort`: fetch the modules
J = importlib.import_module("lsdradixsort_tpu.ops.sort")
T = importlib.import_module("lsdradixsort_tpu_torch.ops.sort")

TILE_LOG = 10


def _cols(seed, n, k):
    """k key columns of mixed dtypes (u32, i32, f32 in turn), few distinct
    values so that ties reach down every column."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(k):
        c = rng.integers(-2, 3, n)
        cols.append([c.astype(np.uint32) + np.uint32(7),
                     c.astype(np.int32),
                     (c * 0.5).astype(np.float32)][j % 3])
    return cols


@pytest.mark.parametrize("k,desc", [
    (2, False), (3, (True, False, True)), (7, True),
    (7, (False, True) * 3 + (False,)), (1, False)])
@pytest.mark.parametrize("strategy", ["merge", "xla"])
def test_sort_lex_matches_jax(k, desc, strategy):
    # 7 columns make 9 streams a pass: the last columns follow by gather
    n = (1 << 12) - 99
    cols = _cols(80 + k, n, k)
    (wc, wp) = J.sort_lex([jnp.asarray(c) for c in cols], descending=desc,
                          strategy="xla")
    gc, gp = T.sort_lex([from_numpy(c) for c in cols], descending=desc,
                        strategy=strategy, tile_log2=TILE_LOG)
    assert len(gc) == k
    for g, w, c in zip(gc, wc, cols, strict=True):
        assert to_numpy(g).dtype == c.dtype
        np.testing.assert_array_equal(to_numpy(g).view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    np.testing.assert_array_equal(to_numpy(gp), np.asarray(wp))


def test_sort_lex_matches_jax_merge_engine():
    n = 1 << 12
    cols = _cols(88, n, 2)
    wc, wp = J.sort_lex([jnp.asarray(c) for c in cols], strategy="merge",
                        tile_log2=TILE_LOG)
    gc, gp = T.sort_lex([from_numpy(c) for c in cols], tile_log2=TILE_LOG)
    for g, w in zip([*gc, gp], [*wc, wp], strict=True):
        np.testing.assert_array_equal(to_numpy(g).view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    order = np.lexsort((cols[1], cols[0].astype(np.int64)))
    np.testing.assert_array_equal(to_numpy(gp), order)


@pytest.mark.parametrize("method", ["row_number", "rank", "dense_rank"])
@pytest.mark.parametrize("desc", [False, True])
def test_window_rank_matches_jax(method, desc):
    rng = np.random.default_rng(90)
    n = (1 << 12) + 17
    part = rng.integers(0, 30, n, dtype=np.uint32)
    order = rng.standard_normal(n).astype(np.float32).round(1)
    want = j_window_rank(jnp.asarray(part), jnp.asarray(order),
                         method=method, descending=desc, strategy="xla")
    before = TF.PLAIN_CALLS["fill_forward_last"]
    got = window_rank(from_numpy(part), from_numpy(order), method=method,
                      descending=desc, tile_log2=TILE_LOG)
    assert TF.PLAIN_CALLS["fill_forward_last"] > before
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_window_rank_semantics():
    # one partition, ORDER BY 10, 20, 20, 30 (shuffled)
    part = from_numpy(np.array([5, 5, 5, 5], np.uint32))
    order = from_numpy(np.array([20, 10, 30, 20], np.int32))
    got = {m: to_numpy(window_rank(part, order, method=m, tile_log2=7))
           for m in ("row_number", "rank", "dense_rank")}
    np.testing.assert_array_equal(got["row_number"], [2, 1, 4, 3])
    np.testing.assert_array_equal(got["rank"], [2, 1, 4, 2])
    np.testing.assert_array_equal(got["dense_rank"], [2, 1, 3, 2])
    with pytest.raises(ValueError):
        window_rank(part, order, method="ntile")


@pytest.mark.parametrize("block_log2", [10, 12])
def test_sort_blocks_kv_matches_jax(block_log2):
    rng = np.random.default_rng(91)
    n = 1 << 13
    k = rng.integers(0, 9, n, dtype=np.uint32)
    v = rng.permutation(n).astype(np.uint32)
    wk, wv = J.sort_blocks_kv(jnp.asarray(k), jnp.asarray(v),
                              block_size=1 << block_log2)
    gk, gv = T.sort_blocks_kv(from_numpy(k), from_numpy(v),
                              block_size=1 << block_log2)
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))


def test_sort_lex_raises():
    x = from_numpy(np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError):
        T.sort_lex([])
    with pytest.raises(ValueError):
        T.sort_lex([x, x], descending=(True,))
    with pytest.raises(ValueError):
        T.sort_lex([x], strategy="composed")
    assert TM.MAX_STREAMS == 8
