"""The port's query operators (lsdradixsort_tpu_torch/ops/{filter,
aggregate,join,topk}.py) on CPU tensors against the JAX package's, on the
same numpy input, bit for bit on the rows each op defines: [:count] for
filters and joins, [:min(count, max_out)] for hash_join_multi,
[:n_unique] for aggregates and unique, everything for lookups and top_k.

The JAX merge engine gives the answer of its "xla" engine (its own tests
hold the two equal), so the JAX "xla" engine is the reference for both of
the port's engines; the port's merge engine runs at tile 2^10. Every JAX
op above 2^15 rows compiles its interpreted compaction anew (several
seconds each), so the filters there are held against JAX in
tests/test_torch_compaction.py, and top_k against JAX for one dtype and
direction."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy

JF = importlib.import_module("lsdradixsort_tpu.ops.filter")
JA = importlib.import_module("lsdradixsort_tpu.ops.aggregate")
JJ = importlib.import_module("lsdradixsort_tpu.ops.join")
JT = importlib.import_module("lsdradixsort_tpu.ops.topk")
TF = importlib.import_module("lsdradixsort_tpu_torch.ops.filter")
TA = importlib.import_module("lsdradixsort_tpu_torch.ops.aggregate")
TJ = importlib.import_module("lsdradixsort_tpu_torch.ops.join")
TT = importlib.import_module("lsdradixsort_tpu_torch.ops.topk")

TILE = 10        # the port's merge engine: tile 2^10, as test_ops.py:177


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype.itemsize == 4 else x


def _same_prefix(got, want, c):
    """The first c rows of each output, bit for bit (c = None: all)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = to_numpy(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(_bits(g)[:c], _bits(w)[:c])


def _check_counted(got, want):
    c = int(want[0])
    assert int(got[0]) == c
    _same_prefix(got[1:], want[1:], c)
    return c


def test_filter_keys_and_kv_match_jax():
    # below the 2^15-row stream tile (sort-based); above it the filters
    # run the streaming compaction, held against JAX in
    # tests/test_torch_compaction.py
    n = 1000
    rng = np.random.default_rng(81)
    keys = _u32(rng, n)
    vals = np.arange(n, dtype=np.uint32)
    lo, hi = np.uint32(1 << 30), np.uint32(3 << 30)
    c = _check_counted(TF.filter_keys(from_numpy(keys), lo, hi),
                       JF.filter_keys(jnp.asarray(keys), lo, hi))
    sel = (keys >= lo) & (keys < hi)
    assert c == int(sel.sum())
    got = TF.filter_kv(from_numpy(keys), from_numpy(vals), lo, hi)
    _check_counted(got, JF.filter_kv(jnp.asarray(keys), jnp.asarray(vals),
                                     lo, hi))
    np.testing.assert_array_equal(to_numpy(got[2])[:c], vals[sel])


def test_compact_moves_float_bits():
    rng = np.random.default_rng(82)
    n = 1 << 16
    keys = _u32(rng, n, 1 << 20)
    f = rng.standard_normal(n).astype(np.float32)
    f[:3] = [np.nan, -0.0, np.inf]
    mask = keys < (1 << 19)
    count, ck, cf = TF.compact(torch.from_numpy(mask), from_numpy(keys),
                               from_numpy(f))
    assert cf.dtype == torch.float32 and int(count) == int(mask.sum())
    np.testing.assert_array_equal(to_numpy(cf)[:int(count)].view(np.uint32),
                                  f[mask].view(np.uint32))
    with pytest.raises(TypeError):
        TF.compact(torch.from_numpy(mask), torch.zeros(n, dtype=torch.int64))


GROUP_KEYS = {
    "u32": lambda rng, n: _u32(rng, n, 50),
    "i32": lambda rng, n: rng.integers(-25, 25, n).astype(np.int32),
    "f32": lambda rng, n: rng.choice(np.array(
        [-1.5, -0.0, 0.0, 2.25, np.inf, -np.inf, 7.0], np.float32), n),
}


@pytest.mark.parametrize("kdt", list(GROUP_KEYS))
@pytest.mark.parametrize("red", ["sum", "min", "max", "count"])
def test_group_by_aggregate_matches_jax(kdt, red):
    rng = np.random.default_rng(83)
    n = 4096
    gk = GROUP_KEYS[kdt](rng, n)
    vals = {"sum": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "min": rng.standard_normal(n).astype(np.float32),
            "max": _u32(rng, n),
            "count": _u32(rng, n)}[red]
    want = JA.group_by_aggregate(jnp.asarray(gk), jnp.asarray(vals),
                                 reduction=red)
    for engine in ("xla", "merge"):
        got = TA.group_by_aggregate(from_numpy(gk), from_numpy(vals),
                                    reduction=red, engine=engine,
                                    tile_log2=TILE)
        assert got[1].dtype == from_numpy(gk).dtype
        _check_counted(got, want)


def test_group_by_sum_u32_and_f32_sum_raises():
    rng = np.random.default_rng(84)
    gk, vals = _u32(rng, 3000, 40), _u32(rng, 3000)
    want = JA.group_by_sum(jnp.asarray(gk), jnp.asarray(vals))
    for engine in ("xla", "merge"):
        _check_counted(TA.group_by_sum(from_numpy(gk), from_numpy(vals),
                                       engine=engine, tile_log2=TILE), want)
    f = rng.standard_normal(3000).astype(np.float32)
    with pytest.raises(TypeError):
        JA.group_by_sum(jnp.asarray(gk), jnp.asarray(f))
    with pytest.raises(TypeError):
        TA.group_by_sum(from_numpy(gk), from_numpy(f))


@pytest.mark.parametrize("engine", ["xla", "merge"])
@pytest.mark.parametrize("case", ["plain", "sentinel"])
def test_filtered_group_by_sum_matches_jax(engine, case):
    rng = np.random.default_rng(85)
    n = 1 << 12
    keys = _u32(rng, n, 1 << 20)
    gk = _u32(rng, n, 1 << 10)
    vals = np.arange(n, dtype=np.uint32)
    if case == "sentinel":           # a real group 0xFFFFFFFF still counts
        gk[rng.random(n) < 0.2] = 0xFFFFFFFF
    lo, hi = np.uint32(1 << 18), np.uint32(1 << 19)
    want = JA.filtered_group_by_sum(jnp.asarray(keys), jnp.asarray(gk),
                                    jnp.asarray(vals), lo, hi)
    got = TA.filtered_group_by_sum(from_numpy(keys), from_numpy(gk),
                                   from_numpy(vals), lo, hi, engine=engine,
                                   tile_log2=TILE)
    c = _check_counted(got, want)
    keep = (keys >= lo) & (keys < hi)
    assert c == np.unique(gk[keep]).size
    if case == "sentinel":
        assert to_numpy(got[1])[c - 1] == 0xFFFFFFFF


def _join_case(rng, case, nb=1000, npr=3000):
    bk = rng.permutation(4 * nb)[:nb].astype(np.uint32)
    bv = _u32(rng, nb)
    pk = (bk.max() + 1 + _u32(rng, npr, 1000) if case == "no_match"
          else _u32(rng, npr, 8 * nb))
    return bk, bv, pk.astype(np.uint32), np.arange(npr, dtype=np.uint32)


@pytest.mark.parametrize("engine", ["xla", "merge"])
@pytest.mark.parametrize("case", ["some_match", "no_match"])
def test_hash_join_matches_jax(engine, case):
    rng = np.random.default_rng(86)
    args = _join_case(rng, case)
    want = JJ.hash_join(*map(jnp.asarray, args))
    got = TJ.hash_join(*map(from_numpy, args), engine=engine, tile_log2=TILE)
    c = _check_counted(got, want)
    assert c == int(np.isin(args[2], args[0]).sum())
    assert (c == 0) == (case == "no_match")


@pytest.fixture(scope="module")
def multi_case():
    rng = np.random.default_rng(87)
    nb, npr = 800, 2500
    bk = _u32(rng, nb, 200)                     # ~4 build rows a key
    bv = np.arange(nb, dtype=np.uint32)
    pk = _u32(rng, npr, 400)
    pv = _u32(rng, npr)
    pv2 = np.arange(npr, dtype=np.uint32)
    valid = rng.random(npr) < 0.8
    return bk, bv, pk, pv, pv2, valid


@pytest.mark.parametrize("engine", ["xla", "merge"])
@pytest.mark.parametrize("max_out", [1 << 13, 1000])     # 1000 truncates
def test_hash_join_multi_matches_jax(multi_case, engine, max_out):
    bk, bv, pk, pv, _, _ = multi_case
    want = JJ.hash_join_multi(*map(jnp.asarray, (bk, bv, pk, pv)),
                              max_out=max_out)
    got = TJ.hash_join_multi(*map(from_numpy, (bk, bv, pk, pv)),
                             max_out=max_out, engine=engine, tile_log2=TILE)
    c = int(want[0])
    assert int(got[0]) == c and (c > max_out) == (max_out == 1000)
    assert all(g.shape == (max_out,) for g in got[1:])
    _same_prefix(got[1:], want[1:], min(c, max_out))


def test_hash_join_multi_streams_valid_and_build_idx(multi_case):
    bk, bv, pk, pv, pv2, valid = multi_case
    kw = dict(max_out=1 << 13, return_build_idx=True)
    want = JJ.hash_join_multi(*map(jnp.asarray, (bk, bv, pk)),
                              (jnp.asarray(pv), jnp.asarray(pv2)),
                              probe_valid=jnp.asarray(valid), **kw)
    got = TJ.hash_join_multi(*map(from_numpy, (bk, bv, pk)),
                             (from_numpy(pv), from_numpy(pv2)),
                             probe_valid=torch.from_numpy(valid), **kw)
    c = int(want[0])
    assert int(got[0]) == c
    assert isinstance(got[2], tuple) and len(got[2]) == 2
    _same_prefix([got[1], *got[2], got[3], got[4]],
                 [want[1], *want[2], want[3], want[4]], c)


def test_probe_lookup64_and_hash_join64_match_jax():
    rng = np.random.default_rng(88)
    nb, npr = 700, 1 << 13
    bhi = _u32(rng, nb, 16)                    # colliding hi planes
    blo = rng.permutation(1 << 20)[:nb].astype(np.uint32)
    bv = _u32(rng, nb)
    pick = rng.integers(0, nb, npr)
    phi, plo = bhi[pick].copy(), blo[pick].copy()
    kind = rng.integers(0, 4, npr)
    phi[kind == 1] ^= np.uint32(0x20)          # miss: hi off, lo matches
    plo[kind == 2] ^= np.uint32(1 << 21)       # miss: lo off, hi matches
    pv = np.arange(npr, dtype=np.uint32)
    want = JJ.probe_lookup64(*map(jnp.asarray, (bhi, blo, bv, phi, plo)))
    got = TJ.probe_lookup64(*map(from_numpy, (bhi, blo, bv, phi, plo)))
    _same_prefix(got, want, None)
    want = JJ.hash_join64(*map(jnp.asarray, (bhi, blo, bv, phi, plo, pv)))
    got = TJ.hash_join64(*map(from_numpy, (bhi, blo, bv, phi, plo, pv)))
    assert _check_counted(got, want) == int((kind == 0).sum() +
                                            (kind == 3).sum())


@pytest.mark.parametrize("case", ["fast", "fallback"])
def test_top_k_matches_jax(case):
    rng = np.random.default_rng(89)
    n, k = 1 << 16, 100                  # budget 2^15 < n: the fast path
    # one high byte for every key: the threshold bin holds all n rows
    keys = _u32(rng, n, 1 << 24 if case == "fallback" else 2**32)
    keys[:5] = keys[7]                   # ties: stable by position
    want = JT.top_k(jnp.asarray(keys), k, largest=True)
    got = TT.top_k(from_numpy(keys), k, largest=True)
    _same_prefix(got, want, None)
    with pytest.raises(ValueError):
        TT.top_k(from_numpy(keys), 0)


@pytest.mark.parametrize("case", ["u32_smallest", "i32", "f32"])
def test_top_k_dtypes_match_stable_argsort(case):
    # the JAX top_k compiles once per dtype and direction (about 10 s
    # each here): these hold the port to the stable order directly
    rng = np.random.default_rng(92)
    n, k = 1 << 16, 300
    keys = {"u32_smallest": _u32(rng, n),
            "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "f32": rng.standard_normal(n).astype(np.float32)}[case]
    keys[:5] = keys[7]
    largest = case != "u32_smallest"
    vals, idx = TT.top_k(from_numpy(keys), k, largest=largest)
    order = np.argsort(-keys.astype(np.float64) if largest else keys,
                       kind="stable")[:k]
    np.testing.assert_array_equal(to_numpy(idx), order.astype(np.uint32))
    np.testing.assert_array_equal(_bits(to_numpy(vals)), _bits(keys[order]))


@pytest.mark.parametrize("dtype", ["u32", "f32"])
def test_unique_matches_jax(dtype):
    rng = np.random.default_rng(90)
    n = 1 << 13
    keys = (_u32(rng, n, 300) if dtype == "u32"
            else rng.integers(-40, 40, n).astype(np.float32))
    want = JT.unique(jnp.asarray(keys))
    got = TT.unique(from_numpy(keys))
    _check_counted(got, want)


def test_unique_merge_path_matches_numpy():
    # from 2^17 rows unique sorts with the framework engine, as the JAX
    # package's; numpy's unique is the golden its tests hold it to
    rng = np.random.default_rng(91)
    keys = _u32(rng, 1 << 17, 5000)
    cnt, uk, counts = TT.unique(from_numpy(keys))
    wk, wc = np.unique(keys, return_counts=True)
    assert int(cnt) == wk.size
    np.testing.assert_array_equal(to_numpy(uk)[:wk.size], wk)
    np.testing.assert_array_equal(to_numpy(counts)[:wk.size], wc)


def test_engines_raise():
    x = from_numpy(np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError):
        TJ.hash_join(x, x, x, x, engine="hash")
    with pytest.raises(ValueError):
        TA.group_by_aggregate(x, x, reduction="median")
    with pytest.raises(ValueError):
        TA.filtered_group_by_sum(x, x, x, 0, 9, engine="hash")


def test_bench_entry_point_ops_agree_with_their_references():
    # chip_smoke.py phase 2 runs these on the card at 2^22; here, through
    # the plain versions, each op against the bench's independent
    # reference, and the path each takes (the vmem fallbacks, top_k's fast
    # path) by the kernel calls it makes
    Q = importlib.import_module("lsdradixsort_tpu_torch.bench.query")
    d = Q.make_data("cpu", 1 << 17, 1 << 13)
    for op in Q.entry_point_ops(d):
        before = Q.kernel_calls()
        op.check(op.run())
        made = {k: v - before[k] for k, v in Q.kernel_calls().items()}
        for k, want in (op.calls or {}).items():
            assert made[k] == want, (Q.label(op), k)
