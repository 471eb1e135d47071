"""The port's lane-bucketed hash table (lsdradixsort_tpu_torch/kernels/
hash_table.py) and the ops that ride it ("vmem" joins, IN-list filters),
on CPU tensors, against the JAX package's (Pallas kernels in interpret
mode), on the same numpy input, bit for bit.

The table is state the two packages share: a table built by the JAX
package is handed, as numpy planes, to the port's probe, which must give
the JAX probe's answer; and the port's build must give the JAX build's
planes."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import hash_table as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import hash_table as T

JF = importlib.import_module("lsdradixsort_tpu.ops.filter")
JJ = importlib.import_module("lsdradixsort_tpu.ops.join")
TF = importlib.import_module("lsdradixsort_tpu_torch.ops.filter")
TJ = importlib.import_module("lsdradixsort_tpu_torch.ops.join")


def _unique_keys(rng, n):
    return rng.permutation(1 << 22)[:n].astype(np.uint32)


def _colliding_keys(count: int):
    """Keys that all hash to one lane: chains overflow."""
    k = np.arange(1, 1 << 20, dtype=np.uint64)
    lanes = ((k * J.MIX) & 0xFFFFFFFF) >> 25
    target = ((12345 * J.MIX) & 0xFFFFFFFF) >> 25
    return k[lanes == target][:count].astype(np.uint32)


def _np(*xs):
    return [np.asarray(x) for x in xs]


def test_lane_of_matches_jax_near_2_32():
    rng = np.random.default_rng(71)
    ks = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        np.arange(2**32 - 300, 2**32, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0x7FFFFFFF, 0x80000000], np.uint32)])
    got = to_numpy(T.lane_of(from_numpy(ks)))
    np.testing.assert_array_equal(got, np.asarray(J.lane_of(jnp.asarray(ks))))
    want = ((ks.astype(np.uint64) * J.MIX) & 0xFFFFFFFF) >> 25
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert T.MIX == J.MIX and T.LANES == J.LANES


@pytest.mark.parametrize("nb", [1, 100, 1024, 3000, 50_000])
def test_plan_rows_matches_jax(nb):
    assert T.plan_rows(nb) == J.plan_rows(nb)


@pytest.mark.parametrize("case", ["100", "1000", "3000", "overflow",
                                  "duplicates"])
def test_build_table_matches_jax(case):
    rng = np.random.default_rng(72)
    if case == "overflow":
        keys, rows = _colliding_keys(6), 4
    elif case == "duplicates":
        keys = rng.choice(_unique_keys(rng, 50), 400).astype(np.uint32)
        rows = T.plan_rows(400)
    else:
        keys = _unique_keys(rng, int(case))
        rows = T.plan_rows(int(case))
    vals = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(
        np.uint32)
    want = J.build_table(jnp.asarray(keys), jnp.asarray(vals), rows)
    got = T.build_table(from_numpy(keys), from_numpy(vals), rows)
    for g, w in zip(got[:3], want[:3], strict=True):
        assert g.dtype == torch.uint32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert bool(got[3]) == bool(want[3])
    if case == "overflow":
        assert not bool(got[3])
        assert int(to_numpy(got[2]).max()) == rows    # clamped, not wrapped


@pytest.fixture(scope="module")
def jax_table():
    """A table built by the JAX package, its probes and the JAX answers."""
    rng = np.random.default_rng(73)
    nb, npr = 1000, 1 << 14
    bk = _unique_keys(rng, nb)
    bv = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.choice(np.concatenate([bk, _unique_keys(rng, nb)]),
                    npr).astype(np.uint32)
    table = J.build_table(jnp.asarray(bk), jnp.asarray(bv), J.plan_rows(nb))
    assert bool(table[3])
    want = {semi: _np(*J.probe_table(*table[:3], jnp.asarray(pk), semi=semi))
            for semi in (False, True)}
    return bk, bv, pk, _np(*table[:3]), want


@pytest.mark.parametrize("semi", [False, True])
def test_probe_of_jax_built_table_matches_jax(jax_table, semi):
    bk, bv, pk, planes, want = jax_table
    m, v = T.probe_table(*(from_numpy(p) for p in planes), from_numpy(pk),
                         semi=semi)
    np.testing.assert_array_equal(to_numpy(m), want[semi][0])
    np.testing.assert_array_equal(to_numpy(v), want[semi][1])
    np.testing.assert_array_equal(to_numpy(m), np.isin(pk, bk))
    if semi:
        assert not to_numpy(v).any()


def test_probe_duplicate_build_keys_last_match_wins():
    rng = np.random.default_rng(74)
    bk = rng.choice(_unique_keys(rng, 60), 500).astype(np.uint32)
    bv = np.arange(500, dtype=np.uint32)
    pk = rng.choice(np.concatenate([bk, _unique_keys(rng, 60)]),
                    2000).astype(np.uint32)
    rows = 64                  # duplicates lengthen the chains
    table = J.build_table(jnp.asarray(bk), jnp.asarray(bv), rows)
    assert bool(table[3])
    wm, wv = _np(*J.probe_table(*table[:3], jnp.asarray(pk)))
    gm, gv = T.probe_table(*T.build_table(from_numpy(bk), from_numpy(bv),
                                          rows)[:3], from_numpy(pk))
    np.testing.assert_array_equal(to_numpy(gm), wm)
    np.testing.assert_array_equal(to_numpy(gv), wv)
    last = {k: v for k, v in zip(bk.tolist(), bv.tolist())}   # last wins
    np.testing.assert_array_equal(
        to_numpy(gv), np.array([last.get(k, 0) for k in pk.tolist()],
                               np.uint32))


def _join_args(rng, nb, npr, colliding=False):
    bk = (_colliding_keys(J.plan_rows(32) + 3) if colliding
          else _unique_keys(rng, nb))
    bv = rng.integers(0, 2**32, bk.size, dtype=np.uint64).astype(np.uint32)
    pk = rng.choice(np.concatenate([bk, bk + np.uint32(1)]),
                    npr).astype(np.uint32)
    return bk, bv, pk, np.arange(npr, dtype=np.uint32)


@pytest.mark.parametrize("case", ["small", "overflow"])
def test_hash_join_vmem_matches_jax(case):
    rng = np.random.default_rng(75)
    bk, bv, pk, pv = _join_args(rng, 2000, 4096, case == "overflow")
    want = _np(*JJ.hash_join(*map(jnp.asarray, (bk, bv, pk, pv)),
                             engine="vmem"))
    got = TJ.hash_join(*map(from_numpy, (bk, bv, pk, pv)), engine="vmem")
    c = int(want[0])
    assert int(got[0]) == c == int(np.isin(pk, bk).sum())
    for g, w in zip(got[1:], want[1:], strict=True):
        np.testing.assert_array_equal(to_numpy(g)[:c], w[:c])


@pytest.mark.parametrize("engine", ["vmem", "vmem_overflow", "xla", "merge"])
def test_probe_lookup_matches_jax(engine):
    rng = np.random.default_rng(76)
    bk, bv, pk, _ = _join_args(rng, 1000, 4096, engine == "vmem_overflow")
    engine = engine.split("_")[0]
    # the JAX engines give one answer (tests/test_hash_table.py); its
    # "xla" one is the reference for the port's merge engine
    want = _np(*JJ.probe_lookup(*map(jnp.asarray, (bk, bv, pk)),
                                engine="xla" if engine == "merge" else engine))
    got = TJ.probe_lookup(*map(from_numpy, (bk, bv, pk)), engine=engine,
                          tile_log2=10)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(to_numpy(g), w)


@pytest.mark.parametrize("case", ["in", "in_overflow", "not_in"])
def test_filter_in_set_matches_jax(case):
    rng = np.random.default_rng(77)
    sk = (_colliding_keys(40) if case == "in_overflow"
          else _unique_keys(rng, 1500))
    n = 20_000                     # below 2^15: the sort-based compaction
    keys = rng.choice(np.concatenate([sk, sk ^ np.uint32(0x400000)]),
                      n).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    jfn, tfn = ((JF.filter_not_in_set, TF.filter_not_in_set)
                if case == "not_in" else (JF.filter_in_set, TF.filter_in_set))
    want = _np(*jfn(jnp.asarray(keys), jnp.asarray(sk), jnp.asarray(vals)))
    got = tfn(from_numpy(keys), from_numpy(sk), from_numpy(vals))
    c = int(want[0])
    mask = np.isin(keys, sk) != (case == "not_in")
    assert int(got[0]) == c == int(mask.sum())
    for g, w, x in zip(got[1:], want[1:], (keys, vals), strict=True):
        np.testing.assert_array_equal(to_numpy(g)[:c], w[:c])
        np.testing.assert_array_equal(to_numpy(g)[:c], x[mask])


def test_invalid_tables_raise():
    tk = from_numpy(np.zeros((4, 128), np.uint32))
    cnt = from_numpy(np.zeros((1, 128), np.uint32))
    keys = from_numpy(np.zeros(8, np.uint32))
    with pytest.raises(ValueError, match="rows"):
        T.probe_table(tk[:, :64], tk[:, :64], cnt, keys)
    with pytest.raises(ValueError, match="uint32"):
        T.probe_table(tk, tk, cnt, torch.zeros(8, dtype=torch.int64))


def test_counters_count_plain_calls_on_cpu():
    launches = dict(T.LAUNCHES)
    plain = dict(T.PLAIN_CALLS)
    keys = from_numpy(np.arange(256, dtype=np.uint32))
    table = T.build_table(keys, keys, T.plan_rows(256))
    T.probe_table(*table[:3], keys, semi=True)
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["probe_table"] == plain["probe_table"] + 1
