"""The port's API against the JAX package's where the two used to differ:
the TPU knobs every kernel wrapper takes, the package's public names,
`random_keys`'s call shape and widths, `Timing`'s fields, the inputs the
port once refused (more than 8 compaction streams, shuffles of any
4-byte dtype, scans of 8- and 16-bit integers, histograms past r = 12)
and `sort_kv` payloads of any pytree. CPU tensors run the plain
versions; the JAX package runs on the CPU, its kernels in interpret mode.
Outputs are integers and must agree bit for bit."""
import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import lsdradixsort_tpu as JP
import lsdradixsort_tpu_torch as TP
from lsdradixsort_tpu.core import datagen as JD
from lsdradixsort_tpu.core import timing as JT
from lsdradixsort_tpu.kernels import histogram as JH
from lsdradixsort_tpu.kernels import scan as JS
from lsdradixsort_tpu_torch import parallel as PAR
from lsdradixsort_tpu_torch.core import datagen, profiling, timing
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import compaction as CP
from lsdradixsort_tpu_torch.kernels import histogram as H
from lsdradixsort_tpu_torch.kernels import merge as M
from lsdradixsort_tpu_torch.kernels import scan as SC
from lsdradixsort_tpu_torch.kernels import shuffle as SH
from lsdradixsort_tpu_torch.kernels import tile_sort as TS
from lsdradixsort_tpu_torch.kernels import transpose as TR

J = importlib.import_module("lsdradixsort_tpu.ops.sort")
T = importlib.import_module("lsdradixsort_tpu_torch.ops.sort")

N = 1 << 12
TILE_ROWS = 8                       # 1024-row tiles
MERGE_KNOBS = dict(buf_elems=1 << 13, blk=128, interpret=True, ce="roll",
                   pipeline=True)


def _u32(n, seed, hi=2**32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _runs(n, run):
    k = _u32(n, 70, 50).reshape(-1, run)
    return from_numpy(np.sort(k, axis=1).reshape(-1))


def _flat(out):
    """A wrapper's output as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    flat = []
    for o in out:
        flat += _flat(o)
    return flat


# each wrapper of a TPU kernel, called with and without the JAX package's
# knobs, in the JAX package's argument order where it is positional
KNOB_CALLS = {
    "sort_tiles": lambda k, kn: TS.sort_tiles(k, TILE_ROWS, **kn),
    "sort_tiles_plain": lambda k, kn: TS.sort_tiles_plain(k, TILE_ROWS, **kn),
    "sort_tiles_kv": lambda k, kn: TS.sort_tiles_kv(k, k, TILE_ROWS, **kn),
    "sort_tiles_kv_plain": lambda k, kn: TS.sort_tiles_kv_plain(
        k, k, TILE_ROWS, **kn),
    "sort_tiles_multi": lambda k, kn: TS.sort_tiles_multi(
        k, [k, k], TILE_ROWS, **kn, ncmp=3),
    "sort_tiles_multi_plain": lambda k, kn: TS.sort_tiles_multi_plain(
        k, [k, k], TILE_ROWS, **kn, ncmp=3),
    "exclusive_scan": lambda k, kn: SC.exclusive_scan(k, 8, **kn),
    "exclusive_scan_plain": lambda k, kn: SC.exclusive_scan_plain(k, 8, **kn),
    "exclusive_scan_hierarchical": lambda k, kn:
        SC.exclusive_scan_hierarchical(k, 8, **kn),
    "block_prefix_sums": lambda k, kn: SC.block_prefix_sums(k, 256, **kn),
    "block_prefix_sums_plain": lambda k, kn: SC.block_prefix_sums_plain(
        k, 256, **kn),
    "block_digit_histograms": lambda k, kn: H.block_digit_histograms(
        k, 4, 1, 512, 8, **kn),
    "block_digit_histograms_plain": lambda k, kn:
        H.block_digit_histograms_plain(k, 4, 1, 512, 8, **kn),
    "digit_histogram": lambda k, kn: H.digit_histogram(k, 8, 0, **kn),
    "transpose_tiled": lambda k, kn: TR.transpose_tiled(
        k.view(32, 128), 32, **kn),
}
MERGE_CALLS = {
    "merge_pass": lambda k, kn: M.merge_pass(k, 512, **kn),
    "merge_pass_kv": lambda k, kn: M.merge_pass_kv(k, k, 512, **kn),
    "merge_pass_multi": lambda k, kn: M.merge_pass_multi(k, [k, k], 512, 3,
                                                         **kn),
    "merge_pass_multi_plain": lambda k, kn: M.merge_pass_multi_plain(
        k, [k, k], 512, 3, **kn),
}


@pytest.mark.parametrize("name", [*KNOB_CALLS, *MERGE_CALLS])
def test_wrappers_take_the_tpu_knobs(name):
    if name in KNOB_CALLS:
        call, keys = KNOB_CALLS[name], from_numpy(_u32(N, 71))
        knobs = dict(interpret=True)
        if name.startswith("sort_tiles"):
            knobs["ce"] = "reshape"
    else:
        call, keys, knobs = MERGE_CALLS[name], _runs(N, 512), MERGE_KNOBS
    for got, want in zip(_flat(call(keys, knobs)), _flat(call(keys, {})),
                         strict=True):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_package_names_match_the_jax_package():
    assert TP.__version__ == JP.__version__
    for name in ("digits", "datagen", "timing", "roofline"):
        assert name in TP.__all__ and getattr(TP, name).__name__.endswith(
            f".core.{name}")
    t = timing.Timing(seconds=0.5, iters=10)
    assert t.iters == 10 and t.gbytes_per_s(2e9) == 4.0
    assert timing.time_fn.__kwdefaults__ == {"iters": 10, "warmup": 1}
    with pytest.raises(RuntimeError):                   # no card here
        timing.time_fn(lambda: None)
    k = from_numpy(_u32(5, 72))
    assert np.array_equal(datagen.to_numpy(k), to_numpy(k))
    a, b = datagen.to_numpy(k, torch.arange(3))
    assert a.dtype == np.uint32 and b.tolist() == [0, 1, 2]


def test_trace_takes_create_perfetto_link(tmp_path):
    with profiling.trace(str(tmp_path), create_perfetto_link=True):
        torch.arange(10).sum()
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize("hot", [0.9, 0.0, 1.0])
def test_skewed_keys_contract(hot):
    n = 20_000
    k = datagen.skewed_keys(n, seed=3, hot_fraction=hot, device="cpu")
    assert k.dtype == torch.uint32 and k.shape == (n,)
    share = float((k.view(torch.int32) == np.int32(-559038737)).float()
                  .mean())                              # 0xDEADBEEF
    assert abs(share - hot) < 0.01
    assert torch.equal(k, datagen.skewed_keys(n, seed=3, hot_fraction=hot,
                                              device="cpu"))
    cold = k.view(torch.int32)[k.view(torch.int32) != -559038737]
    if cold.numel():                 # the rest spreads over all 32 bits
        assert cold.unique().numel() > 0.99 * cold.numel()
    k2 = datagen.skewed_keys(100, seed=4, hot_key=7, device="cpu")
    assert int((k2.view(torch.int32) == 7).sum()) > 50


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32"])
def test_random_keys_draws_n_keys_of_the_dtype(dtype):
    # the JAX package draws n keys of the dtype's own width
    want = JD.random_keys(8, 0, getattr(jnp, dtype))
    got = datagen.random_keys(8, 0, "cpu", getattr(torch, dtype))
    assert tuple(got.shape) == want.shape == (8,)
    assert got.dtype == getattr(torch, dtype) and got.device.type == "cpu"
    assert not torch.equal(got, datagen.random_keys(8, 1, "cpu",
                                                    getattr(torch, dtype)))


def test_random_keys_takes_the_jax_call_shape():
    # random_keys(n, seed, dtype), as in the JAX package: the dtype in the
    # third place, the keys on the card (or, with a fourth argument, on the
    # device named there)
    want = datagen.random_keys(16, 3, "cpu", torch.uint8)
    got = datagen.random_keys(16, 3, torch.uint8, "cpu")
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    if torch.cuda.is_available():
        keys = datagen.random_keys(16, 3, torch.uint32)
        assert keys.dtype == torch.uint32 and keys.device.type == "cuda"
    else:                       # the card's generator, which is not here
        with pytest.raises(RuntimeError):
            datagen.random_keys(16, 3, torch.uint32)
    assert datagen.random_keys(16, 3, "cpu").dtype == torch.uint32


def test_timing_has_calls_per_iter():
    t = timing.Timing(0.5, 10, 1)
    assert t.calls_per_iter == 1
    assert timing.Timing(0.5, 10).calls_per_iter == 1
    assert [f.name for f in dataclasses.fields(timing.Timing)] == [
        f.name for f in dataclasses.fields(JT.Timing)]
    assert dataclasses.fields(timing.Timing)[2].default == 1


@pytest.mark.parametrize("k", [8, 9, 16, 17])
def test_compaction_stream_groups(k):
    groups = CP.stream_groups(k)
    assert all(len(g) <= CP.MAX_STREAMS for g in groups)
    assert [i for g in groups for i in g] == list(range(k))
    assert len(groups) == -(-k // CP.MAX_STREAMS)


def test_compaction_of_more_than_8_streams():
    n = 1 << 15
    rng = np.random.default_rng(73)
    m = (rng.random(n) < 0.3).astype(np.uint32)
    xs = [_u32(n, 80 + i) for i in range(16)]
    got = CP.compact_stream_multi(from_numpy(m), [from_numpy(x) for x in xs])
    cnt = int(m.sum())
    for g, x in zip(got, xs, strict=True):
        np.testing.assert_array_equal(to_numpy(g)[:cnt], x[m == 1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_shuffles_move_any_4_byte_dtype(dtype):
    x = from_numpy(_u32(16 * 128, 74)).view(16, 128)
    t = torch.tensor([0, 4, 8, 12], dtype=torch.int32)
    d = t.flip(0).contiguous()
    want = SH.shuffle_row_runs(x, t, d, t * 0 + 4, 16)
    got = SH.shuffle_row_runs(x.view(dtype), t, d, t * 0 + 4, 16)
    assert got.dtype == torch.uint32 and torch.equal(got.view(torch.int32),
                                                     want.view(torch.int32))
    w = x.view(-1)
    want = SH.shuffle_elem_runs(w, t * 100 + 1, d * 90, t * 0 + 77, 2048)
    got = SH.shuffle_elem_runs(w.view(dtype), t * 100 + 1, d * 90,
                               t * 0 + 77, 2048)
    assert got.dtype == torch.uint32 and torch.equal(got.view(torch.int32),
                                                     want.view(torch.int32))


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16"])
def test_scans_of_narrow_dtypes_match_jax(dtype):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(75)
    a = rng.integers(info.min, info.max + 1, 3000).astype(dtype)
    want = np.asarray(JS.exclusive_scan(jnp.asarray(a), block_rows=8))
    x = torch.from_numpy(a)
    for fn in (SC.exclusive_scan, SC.exclusive_scan_plain,
               SC.exclusive_scan_hierarchical):
        got = fn(x)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    v = a[:2048].astype(np.int64).reshape(-1, 512)
    scans, totals = SC.block_prefix_sums(x[:2048], 512)
    assert scans.dtype == totals.dtype == x.dtype
    np.testing.assert_array_equal(scans.numpy(), (np.cumsum(v, 1) - v)
                                  .astype(dtype).reshape(-1))
    np.testing.assert_array_equal(totals.numpy(), v.sum(1).astype(dtype))


@pytest.mark.parametrize("r,group,block", [(13, 0, 1 << 13), (16, 1, 1 << 14)])
def test_histograms_past_r12_match_jax(r, group, block):
    keys = _u32(1 << 14, 76)
    want = np.asarray(JH.block_digit_histograms(jnp.asarray(keys), r, group,
                                                block))
    got = H.block_digit_histograms(from_numpy(keys), r, group, block)
    np.testing.assert_array_equal(to_numpy(got), want)
    with pytest.raises(ValueError):
        H.block_digit_histograms(from_numpy(keys), 32, 0, block)


def _payloads(n, seed, as_dict):
    """The payload pytree, built with f from three numpy columns."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    c = _u32(n, seed + 1)
    if as_dict:
        return lambda f: {"a": f(a), "b": (f(b), f(c))}
    return lambda f: (f(a), (f(b), [f(c)]))


@pytest.mark.parametrize("strategy", ["merge", "xla"])
@pytest.mark.parametrize("as_dict", [True, False])
def test_sort_kv_pytree_payloads_match_jax(strategy, as_dict):
    n = 3000
    keys = _u32(n, 77, 400)                 # ties: stability shows
    make = _payloads(n, 78, as_dict)
    wk, wv = J.sort_kv(jnp.asarray(keys), make(jnp.asarray),
                       strategy=strategy, tile_log2=10)
    gk, gv = T.sort_kv(from_numpy(keys), make(from_numpy), strategy=strategy,
                       tile_log2=10)
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    got = torch.utils._pytree.tree_leaves(gv)
    want = jax.tree.leaves(wv)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    if as_dict:
        assert set(gv) == {"a", "b"} and isinstance(gv["b"], tuple)
    else:
        assert isinstance(gv[1][1], list)


# --- the one sort seam of ops/sort.py ---------------------------------------

SEAM_N = 3000       # not a multiple of the tile: a short last tile and run
SEAM_TILE = 8       # 256-row tiles: 16 tiles a sort, two merge passes


def _dist_sort_kv_world_of_one(keys, vals, engine):
    """dist_sort_kv on a gloo world of one in this process, torn down."""
    mesh = PAR.make_mesh(backend="gloo", device="cpu")
    try:
        return PAR.dist_sort_kv(keys, vals, mesh, engine=engine,
                               tile_log2=SEAM_TILE)
    finally:
        dist.destroy_process_group()


def _seam_ops():
    """Each operator that sorts through the seam, as fn(engine) on tiny
    CPU columns (the keys tie; records, join and 64-bit keys as their
    callers shape them)."""
    rng = np.random.default_rng(80)
    n, t = SEAM_N, SEAM_TILE
    k = from_numpy(_u32(n, 81, 400))
    v = from_numpy(_u32(n, 82))
    f = from_numpy(rng.standard_normal(n).astype(np.float32))
    rec = torch.from_numpy(rng.integers(0, 256, (n, 16), dtype=np.uint8))
    bk = from_numpy(np.arange(0, 800, 2, dtype=np.uint32))
    return {
        "sort": lambda e: TP.sort(k, strategy=e),
        "sort_kv": lambda e: TP.sort_kv(k, (v, f), strategy=e, tile_log2=t),
        "sort_lex": lambda e: TP.sort_lex([k, v, f], strategy=e,
                                          tile_log2=t),
        "sort_records": lambda e: TP.sort_records(rec, 10, strategy=e,
                                                  tile_log2=t),
        "sort64_with_ranks": lambda e: TP.sort64_with_ranks(
            k, v, strategy=e, tile_log2=t),
        "hash_join": lambda e: TP.hash_join(bk, bk, k, v, engine=e,
                                            tile_log2=t),
        "filtered_group_by_sum": lambda e: TP.filtered_group_by_sum(
            v, k, v, 0, 1 << 31, engine=e, tile_log2=t),
        "group_by.count": lambda e: TP.group_by_aggregate(
            k, v, "count", engine=e, tile_log2=t),
        "group_by.sum": lambda e: TP.group_by_aggregate(
            k, v, "sum", engine=e, tile_log2=t),
        "group_by.min": lambda e: TP.group_by_aggregate(
            k, f, "min", engine=e, tile_log2=t),
        "unique": lambda e: TP.unique(k),
        "dist_sort_kv": lambda e: _dist_sort_kv_world_of_one(k, f, e),
    }


# (operator, engine): the plain calls of sort_tiles, sort_tiles_kv,
# sort_tiles_multi and merge_pass_multi, and the host syncs and int64
# bytes one call adds: the kernel calls as the operators made them before
# they shared the seam, the bytes and syncs of a chain over the n rows
# alone; `unique` picks its engine by size
SEAM_COUNTS = {
    ("sort", "merge"): (1, 0, 0, 0, 0, 24000),
    ("sort_kv", "merge"): (0, 0, 1, 2, 0, 144000),
    ("sort_lex", "merge"): (0, 0, 3, 6, 0, 432000),
    ("sort_records", "merge"): (0, 0, 3, 6, 0, 432000),
    ("sort64_with_ranks", "merge"): (0, 0, 1, 2, 0, 216000),
    ("sort64_with_ranks", "merge2"): (0, 0, 2, 4, 0, 288000),
    ("hash_join", "merge"): (0, 0, 1, 2, 0, 163200),
    ("hash_join", "xla"): (0, 0, 0, 0, 0, 27200),
    ("filtered_group_by_sum", "merge"): (0, 0, 1, 2, 0, 264000),
    ("group_by.count", "merge"): (1, 0, 0, 2, 0, 96000),
    ("group_by.count", "xla"): (0, 0, 0, 0, 0, 48000),
    ("group_by.sum", "merge"): (0, 0, 1, 2, 0, 240000),
    ("group_by.sum", "xla"): (0, 0, 0, 0, 0, 120000),
    ("group_by.min", "merge"): (0, 0, 1, 2, 0, 144000),
    ("group_by.min", "xla"): (0, 0, 0, 0, 0, 48000),
    ("unique", None): (0, 0, 0, 0, 0, 48008),
    ("dist_sort_kv", "auto"): (0, 0, 0, 0, 1, 96000),
    ("dist_sort_kv", "merge"): (0, 0, 2, 4, 1, 288000),
}


@pytest.mark.parametrize("op,engine", list(SEAM_COUNTS))
def test_operators_keep_their_paths_through_the_seam(op, engine):
    call = _seam_ops()[op]
    before = (dict(TS.PLAIN_CALLS), dict(M.PLAIN_CALLS),
              dict(profiling.COUNTS))
    call(engine)
    got = (*(TS.PLAIN_CALLS[w] - before[0][w]
             for w in ("sort_tiles", "sort_tiles_kv", "sort_tiles_multi")),
           M.PLAIN_CALLS["merge_pass_multi"] - before[1]["merge_pass_multi"],
           *(profiling.COUNTS[c] - before[2][c]
             for c in ("host_syncs", "int64_bytes")))
    assert got == SEAM_COUNTS[op, engine]
    if engine is not None:
        # one text for an unknown engine, whichever operator meets it
        with pytest.raises(ValueError, match=re.escape(
                "unknown engine 'bogus': the sort engines are 'merge', "
                "'xla' and 'auto'")):
            call("bogus")
