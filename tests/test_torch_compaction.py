"""The port's stream compaction (lsdradixsort_tpu_torch/kernels/compaction.py)
on CPU tensors — the plain PyTorch version — against the JAX package's
Pallas kernel in interpret mode, on the same numpy input, and the filters
above the 2^15-row stream tile that run it. Only the first sum(mask) rows
of each output are defined; they must agree bit for bit.

The kernel's JAX calls share one shape (2 tiles of 2^15 rows, 3 streams),
so the interpreted kernel compiles once (a module-scoped fixture); the
ragged `compact` cases pad to that shape too."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import compaction as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import compaction as T

JF = importlib.import_module("lsdradixsort_tpu.ops.filter")
TF = importlib.import_module("lsdradixsort_tpu_torch.ops.filter")

N = 2 << 15
MASKS = ("p0", "p0.01", "p0.5", "p1", "every7")


def _mask(kind, rng):
    if kind == "every7":         # 1/7 selectivity: never row-aligned, so
        m = np.zeros(N, np.uint32)   # carries cross the tile boundary
        m[::7] = 1
        return m
    return (rng.random(N) < float(kind[1:])).astype(np.uint32)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(61)
    xs = [rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
          for _ in range(3)]
    xs[1] = np.arange(N, dtype=np.uint32)
    out = {}
    for kind in MASKS:
        m = _mask(kind, rng)
        want = J.compact_stream_multi(jnp.asarray(m),
                                      [jnp.asarray(x) for x in xs])
        out[kind] = (m, [np.asarray(w) for w in want])
    return xs, out


@pytest.mark.parametrize("kind", MASKS)
def test_compact_stream_multi_matches_jax(cases, kind):
    xs, out = cases
    m, want = out[kind]
    cnt = int(m.sum())
    got = T.compact_stream_multi(from_numpy(m), [from_numpy(x) for x in xs])
    assert len(got) == 3
    for g, w, x in zip(got, want, xs, strict=True):
        assert g.dtype == torch.uint32 and g.shape == (N,)
        np.testing.assert_array_equal(to_numpy(g)[:cnt], w[:cnt])
        np.testing.assert_array_equal(to_numpy(g)[:cnt], x[m == 1])


@pytest.mark.parametrize("kind", ["p0.5", "every7"])
def test_compact_stream_one_stream_and_bool_mask(cases, kind):
    xs, out = cases
    m, want = out[kind]
    cnt = int(m.sum())
    for mask in (from_numpy(m), torch.from_numpy(m == 1)):
        got = T.compact_stream(mask, from_numpy(xs[0]))
        np.testing.assert_array_equal(to_numpy(got)[:cnt], want[0][:cnt])


def test_filter_ops_above_the_stream_tile_match_jax():
    # n is not a tile multiple: compact pads with mask-0 rows
    rng = np.random.default_rng(64)
    n = N - 1234
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    lo, hi = np.uint32(1 << 30), np.uint32(3 << 30)
    sel = (keys >= lo) & (keys < hi)
    c = int(sel.sum())
    want = JF.filter_keys(jnp.asarray(keys), lo, hi)
    got = TF.filter_keys(from_numpy(keys), lo, hi)
    assert int(got[0]) == int(want[0]) == c
    np.testing.assert_array_equal(to_numpy(got[1])[:c],
                                  np.asarray(want[1])[:c])
    want = JF.filter_kv(jnp.asarray(keys), jnp.asarray(vals), lo, hi)
    got = TF.filter_kv(from_numpy(keys), from_numpy(vals), lo, hi)
    assert int(got[0]) == int(want[0]) == c
    for g, w, x in zip(got[1:], want[1:], (keys, vals), strict=True):
        assert g.shape == (n,)
        np.testing.assert_array_equal(to_numpy(g)[:c], np.asarray(w)[:c])
        np.testing.assert_array_equal(to_numpy(g)[:c], x[sel])


@pytest.fixture(scope="module")
def ragged():
    # ops/filter.py compact at n = N - 1234 with a u32, an i32 and an f32
    # column: the JAX op pads to 2 tiles of 3 streams (the kernel shape of
    # `cases`); the port compacts the n rows as they are
    rng = np.random.default_rng(65)
    n = N - 1234
    cols = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
            rng.standard_normal(n).astype(np.float32))
    out = {}
    for kind in ("p0.01", "p0.5", "every7"):
        m = _mask(kind, rng)[:n] == 1
        want = JF.compact(jnp.asarray(m), *(jnp.asarray(c) for c in cols))
        out[kind] = (m, [np.asarray(w) for w in want])
    return cols, out


@pytest.mark.parametrize("kind", ["p0.01", "p0.5", "every7"])
def test_compact_at_a_ragged_n_matches_jax(ragged, kind):
    cols, out = ragged
    m, want = out[kind]
    c = int(m.sum())
    got = TF.compact(torch.from_numpy(m), *(from_numpy(x) for x in cols))
    assert int(got[0]) == int(want[0]) == c
    assert got[0].dtype == torch.uint32 and got[0].dim() == 0
    for g, w, x in zip(got[1:], want[1:], cols, strict=True):
        assert g.shape == x.shape and to_numpy(g).dtype == x.dtype
        np.testing.assert_array_equal(to_numpy(g)[:c].view(np.uint32),
                                      w[:c].view(np.uint32))
        np.testing.assert_array_equal(to_numpy(g)[:c].view(np.uint32),
                                      x[m].view(np.uint32))
    # the any-n entry under it: the count, and the plain version's zero tail
    count, outs = T._compact_rows(torch.from_numpy(m),
                                  [from_numpy(cols[0]), from_numpy(cols[1])
                                   .view(torch.uint32)])
    assert int(count) == c and len(outs) == 2
    for g, x in zip(outs, cols, strict=False):
        assert g.dtype == torch.uint32 and g.shape == (m.shape[0],)
        np.testing.assert_array_equal(to_numpy(g)[:c], x[m].view(np.uint32))
        assert not to_numpy(g)[c:].any()


def test_cuda_limits_match_the_source():
    # the wrapper sizes the look-back scratch, the offsets and the stream
    # groups from its own copies of csrc/compaction.cu's limits
    import re
    from pathlib import Path
    src = (Path(T.__file__).resolve().parent.parent / "csrc"
           / "compaction.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] == T.CTA_THREADS
    assert consts["kMaxStreams"] == T.MAX_STREAMS
    rows = set(map(int, re.findall(r"tile_rows != (\d+) \* kThreads", src)))
    assert {T.tile_rows(k) for k in range(1, T.MAX_STREAMS + 1)} == {
        r * T.CTA_THREADS for r in rows}


def test_n_must_be_a_tile_multiple():
    x = from_numpy(np.zeros(N - 128, np.uint32))
    with pytest.raises(ValueError, match="multiple"):
        T.compact_stream(x, x)
    with pytest.raises(ValueError, match="multiple"):
        J.compact_stream(jnp.zeros(N - 128, jnp.uint32),
                         jnp.zeros(N - 128, jnp.uint32))
    with pytest.raises(ValueError, match="uint32"):
        T.compact_stream(from_numpy(np.zeros(N, np.uint32)),
                         torch.zeros(N, dtype=torch.int64))


def test_counters_count_plain_calls_on_cpu():
    launches = dict(T.LAUNCHES)
    plain = dict(T.PLAIN_CALLS)
    x = from_numpy(np.ones(N, np.uint32))
    T.compact_stream_multi(x, [x, x])
    T._compact_rows(x[:-5], [x[:-5]])
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["compact_stream_multi"] == (
        plain["compact_stream_multi"] + 2)
