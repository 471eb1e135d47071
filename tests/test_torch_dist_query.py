"""The port's distributed query operators (lsdradixsort_tpu_torch/parallel/
dist_query.py), `undistribute` and `dryrun_multichip` against the JAX
package, on the same numpy inputs: the port on an 8-rank gloo world of
CPU processes (parallel/launch.py), JAX on conftest's 8-virtual-device
mesh. Every case of tests/test_dist_query.py at its size and seed: the
group-by's random, all-equal, all-unique and boundary-run keys, the
joins' cases (a probe run around the build row's rank, no matches), the
d = 2 and 4 meshes as make_mesh subgroups of the same world, the filter,
the many-to-many join's cases (all-equal keys balanced, runs across
ranks), top-k with ties and skew, unique, and the config-5 plan (filter,
join, group-by with host glue between the stages). The world is spawned
once for the module; each case is one test. Ragged outputs compare each
rank's count and its rows on [:count] with the JAX shard's, top-k and
the plan the replicated result on every rank, bit for bit."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort_tpu import parallel as JP
from lsdradixsort_tpu.parallel import dist_query as JQ
from lsdradixsort_tpu_torch import entry as TE
from lsdradixsort_tpu_torch import parallel as TP
from lsdradixsort_tpu_torch.parallel import launch

WORLD = 8
U32 = 1 << 32


def _u32(rng, n, hi):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _group_by(keys, vals, d=WORLD):
    return ((TP.dist_group_by_sum, (keys, vals), {}, d),
            lambda m, k=keys, v=vals: JP.dist_group_by_sum(
                jnp.asarray(k), jnp.asarray(v), mesh=m), d, "ragged")


def _join(bk, bv, pk, pv, d=WORLD):
    return ((TP.dist_join, (bk, bv, pk, pv), {}, d),
            lambda m: JP.dist_join(jnp.asarray(bk), jnp.asarray(bv),
                                   jnp.asarray(pk), jnp.asarray(pv), mesh=m),
            d, "ragged")


def _join_multi(bk, bv, pk, pv, max_out=1 << 14):
    return ((TP.dist_join_multi, (bk, bv, pk, pv), {"max_out": max_out},
             WORLD),
            lambda m: JP.dist_join_multi(
                *(JP.shard_1d(jnp.asarray(x), m) for x in (bk, bv, pk, pv)),
                mesh=m, max_out=max_out), WORLD, "ragged")


def _top_k(keys, k, **kw):
    return ((TP.dist_top_k, (keys, k), kw, WORLD),
            lambda m: JP.dist_top_k(JP.shard_1d(jnp.asarray(keys), m), k,
                                    mesh=m, **kw), WORLD, "replicated")


def _config5_jax(m, bk, bv, pk, pv):
    """The JAX package's config-5 plan, as tests/test_dist_query.py runs
    it: filter, join, group-by, with host glue between the stages."""
    d = WORLD
    counts, fk, fv = JP.dist_filter_kv(jnp.asarray(pk), jnp.asarray(pv),
                                       0, 500, mesh=m)
    total, ck, cv = JQ.undistribute(counts, fk, fv)
    pad = -total % d
    ck = np.pad(ck, (0, pad), constant_values=0xFFFFFFFF)
    cv = np.pad(cv, (0, pad))
    jc, jk, jpv, jbv, _ = JP.dist_join(
        jnp.asarray(bk), jnp.asarray(bv), JP.shard_1d(jnp.asarray(ck), m),
        JP.shard_1d(jnp.asarray(cv), m), mesh=m)
    jt, _, mpv, mbv = JQ.undistribute(jc, jk, jpv, jbv)
    pad2 = -jt % d
    gk = np.pad(mbv, (0, pad2), constant_values=0xFFFFFFFF)
    gv = np.pad(mpv, (0, pad2))
    gc, guk, gsums = JP.dist_group_by_sum(
        JP.shard_1d(jnp.asarray(gk), m), JP.shard_1d(jnp.asarray(gv), m),
        mesh=m)
    return JQ.undistribute(gc, guk, gsums)


def _cases() -> dict:
    """case id -> (the port's call for launch.run_cases: (fn, args,
    kwargs, n_devices), the JAX call, the mesh size, the comparison)."""
    c = {}
    rng = np.random.default_rng(0)
    n = 1 << 12
    c["group_by_random"] = _group_by(_u32(rng, n, 200), _u32(rng, n, U32))
    n = 1 << 10
    c["group_by_all_equal"] = _group_by(np.full(n, 7, np.uint32),
                                        np.arange(n, dtype=np.uint32))
    rng = np.random.default_rng(1)
    c["group_by_all_unique"] = _group_by(
        rng.permutation(n).astype(np.uint32),
        rng.integers(0, 1000, n).astype(np.uint32))
    n = 1 << 12
    c["group_by_boundary_runs"] = _group_by(
        np.sort(np.random.default_rng(2).integers(0, 3, n)).astype(np.uint32),
        np.arange(n, dtype=np.uint32))

    rng = np.random.default_rng(3)
    nb, npr = 1 << 9, 1 << 11
    c["join_random"] = _join(rng.permutation(1 << 10)[:nb].astype(np.uint32),
                             _u32(rng, nb, U32), _u32(rng, npr, 1 << 10),
                             _u32(rng, npr, U32))
    nb, npr = 8, 1 << 11
    bk = np.arange(nb, dtype=np.uint32)
    c["join_all_probe_same_key"] = _join(bk, bk * np.uint32(10),
                                         np.full(npr, 3, np.uint32),
                                         np.arange(npr, dtype=np.uint32))
    npr = 1 << 9
    c["join_no_matches"] = _join(bk, bk, np.full(npr, 10_000, np.uint32),
                                 np.arange(npr, dtype=np.uint32))
    rng = np.random.default_rng(4)
    npr = 1 << 11
    c["join_probe_before_and_after_build_shard"] = _join(
        bk, bk * np.uint32(100),
        np.concatenate([np.full(npr // 2, 0, np.uint32),
                        np.full(npr // 2, 7, np.uint32)]),
        rng.integers(0, 100, npr).astype(np.uint32))

    for d in (2, 4):
        rng = np.random.default_rng(d)
        n = 1 << 10
        keys, vals = _u32(rng, n, 50), _u32(rng, n, U32)
        c[f"group_by_small_mesh-{d}"] = _group_by(keys, vals, d)
        nb = 64
        bk = rng.permutation(128)[:nb].astype(np.uint32)
        bv = _u32(rng, nb, U32)
        c[f"join_small_mesh-{d}"] = _join(bk, bv, _u32(rng, n, 128),
                                          _u32(rng, n, U32), d)

    rng = np.random.default_rng(9)
    n = 1 << 12
    keys, vals = _u32(rng, n, 1000), _u32(rng, n, U32)
    c["dist_filter_kv"] = (
        (TP.dist_filter_kv, (keys, vals, 100, 600), {}, WORLD),
        lambda m, k=keys, v=vals: JP.dist_filter_kv(
            jnp.asarray(k), jnp.asarray(v), 100, 600, mesh=m), WORLD,
        "ragged")

    rng = np.random.default_rng(33)
    nb, npr = 1 << 8, 1 << 13
    plan = (rng.permutation(1 << 9)[:nb].astype(np.uint32),
            _u32(rng, nb, 100), _u32(rng, npr, 1 << 9), _u32(rng, npr, 1000))
    c["config5_distributed_query_pipeline"] = (
        (TE.config5_plan, plan, {}, WORLD),
        lambda m: _config5_jax(m, *plan), WORLD, "replicated")

    rng = np.random.default_rng(0)
    nb, npr = 1 << 10, 1 << 12
    c["join_multi_random"] = _join_multi(
        rng.integers(0, 200, nb, dtype=np.uint32), _u32(rng, nb, U32),
        rng.integers(0, 300, npr, dtype=np.uint32), _u32(rng, npr, U32))
    nb = npr = 1 << 7
    c["join_multi_all_equal_keys_balanced"] = _join_multi(
        np.full(nb, 42, dtype=np.uint32), np.arange(nb, dtype=np.uint32),
        np.full(npr, 42, dtype=np.uint32),
        np.arange(npr, dtype=np.uint32) + 1000, max_out=1 << 11)
    nb, npr = 1 << 6, 1 << 7
    bk = np.arange(nb, dtype=np.uint32)
    pk = np.arange(1000, 1000 + npr, dtype=np.uint32)
    c["join_multi_no_matches"] = _join_multi(bk, bk, pk, pk, max_out=256)
    rng = np.random.default_rng(7)
    nb, npr = 1 << 9, 1 << 10
    c["join_multi_runs_span_shards"] = _join_multi(
        _u32(rng, nb, 5), _u32(rng, nb, U32), _u32(rng, npr, 8),
        _u32(rng, npr, U32), max_out=1 << 17)
    rng = np.random.default_rng(3)
    nb, npr = 1 << 9, 1 << 11
    unique = (rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb],
              _u32(rng, nb, U32), _u32(rng, npr, 2 * nb), _u32(rng, npr, U32))
    c["join_multi_unique_matches"] = _join_multi(*unique)
    c["join_unique_matches_join_multi"] = (
        (TP.dist_join, unique, {}, WORLD),
        lambda m: JP.dist_join(*(JP.shard_1d(jnp.asarray(x), m)
                                 for x in unique), mesh=m), WORLD, "ragged")

    rng = np.random.default_rng(5)
    keys = _u32(rng, 1 << 13, U32)
    for largest in (True, False):
        c[f"dist_top_k-{largest}"] = _top_k(keys, 37, largest=largest)
    c["dist_top_k_ties_across_shards"] = _top_k(np.full(1 << 13, 9,
                                                        np.uint32), 64)
    rng = np.random.default_rng(6)
    keys = _u32(rng, 1 << 13, 1 << 16)
    shard = (1 << 13) // 8
    keys[3 * shard: 3 * shard + 200] += np.uint32(1 << 30)
    c["dist_top_k_skewed_one_shard"] = _top_k(keys, 50)

    keys = _u32(np.random.default_rng(12), 1 << 12, 97)
    c["dist_unique"] = ((TP.dist_unique, (keys,), {}, WORLD),
                        lambda m, k=keys: JP.dist_unique(jnp.asarray(k),
                                                         mesh=m),
                        WORLD, "ragged")

    # ragged shards of three columns: counts per rank, rows past them junk
    rng = np.random.default_rng(21)
    counts = np.array([0, 5, 64, 1, 17, 64, 33, 2], dtype=np.uint32)
    cols = (_u32(rng, WORLD * 64, U32),
            rng.standard_normal(WORLD * 64).astype(np.float32),
            rng.integers(-9, 9, WORLD * 64).astype(np.int32))
    c["undistribute"] = ((TP.undistribute, (counts, *cols), {}, WORLD),
                         lambda m: JQ.undistribute(counts, *cols), WORLD,
                         "replicated")
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    """Every case on one spawned world: case id -> each rank's output."""
    ids = list(CASES)
    ranks = launch.run(WORLD, launch.run_cases, [CASES[c][0] for c in ids],
                       backend="gloo", device="cpu")
    return {c: [r[i] for r in ranks] for i, c in enumerate(ids)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax(port, case):
    _, jax_call, d, kind = CASES[case]
    want = [np.asarray(w) for w in jax_call(JP.make_mesh(d))]
    assert all(x is None for x in port[case][d:])    # outside the mesh
    got = port[case][:d]
    if kind == "replicated":
        for rank, g in enumerate(got):
            assert len(g) == len(want)
            for i, w in enumerate(want):
                np.testing.assert_array_equal(_bits(g[i]), _bits(w),
                                              f"rank {rank}, output {i}")
        return
    counts = want[0]
    for rank, g in enumerate(got):        # each shard's defined rows
        c = int(g[0][0])
        assert c == int(counts[rank]), (rank, c, int(counts[rank]))
        for i, w in enumerate(want[1:], 1):
            per = w.shape[0] // d
            assert g[i].shape[0] == per and g[i].dtype == w.dtype
            m = min(c, per)
            np.testing.assert_array_equal(
                _bits(g[i][:m]), _bits(w[rank * per:rank * per + m]),
                f"rank {rank}, output {i}")


def test_dryrun_multichip_8_ranks_on_the_cpu(capsys):
    TE.dryrun_multichip(8, backend="gloo", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all("verified" in x for x in lines)
    assert all(x.startswith("dryrun_multichip(8): ") for x in lines)
