"""The port's distributed sort layer (lsdradixsort_tpu_torch/parallel/:
mesh, dist_hist, dist_sort) against the JAX package, on the same numpy
inputs: the port on an 8-rank gloo world of CPU processes
(parallel/launch.py), JAX on conftest's 8-virtual-device mesh. Every
case of tests/test_parallel.py at its size and seed: the five skews, f32
descending and i32 keys, the merge engine forced (the port at tile 2^10,
the kernels' plain versions; JAX at its tile 2^7), the balanced shards
under all-equal keys, the histogram, and the D = 1 mesh, here a
make_mesh(1) subgroup of the same world. The world is spawned once for
the module; each case is one test. Sorts compare whole shards, the
histogram its replicated result on every rank, bit for bit."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax.numpy as jnp

from lsdradixsort_tpu import parallel as JP
from lsdradixsort_tpu_torch import parallel as TP
from lsdradixsort_tpu_torch.parallel import launch

WORLD = 8
TILE = 10           # the port's merge engine in tests: tile 2^10


def _keys(rng, n, hi=1 << 32):
    return rng.integers(0, hi, size=n, dtype=np.uint32)


SKEWS = {
    "uniform": lambda rng, n: _keys(rng, n),
    "all_equal": lambda rng, n: np.full(n, 7, dtype=np.uint32),
    "sorted": lambda rng, n: np.sort(_keys(rng, n)),
    "one_hot_key": lambda rng, n: np.where(rng.random(n) < 0.9,
                                           np.uint32(42), _keys(rng, n)),
    "few_uniques": lambda rng, n: _keys(rng, n, hi=3),
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cases() -> dict:
    """case id -> (the port's call for launch.run_cases: (fn, args,
    kwargs, n_devices), the JAX call, the JAX mesh size)."""
    cases = {}
    for kind in SKEWS:
        keys = SKEWS[kind](_rng(), 1 << 13)
        cases[f"dist_sort-{kind}"] = (
            (TP.dist_sort, (keys,), {}, None),
            lambda m, k=keys: JP.dist_sort(JP.shard_1d(jnp.asarray(k), m), m),
            WORLD)
    for kind in ("uniform", "all_equal", "one_hot_key", "few_uniques"):
        n = 1 << 12
        keys, vals = SKEWS[kind](_rng(), n), np.arange(n, dtype=np.uint32)
        cases[f"dist_sort_kv_stable-{kind}"] = (
            (TP.dist_sort_kv, (keys, vals), {}, None),
            lambda m, k=keys, v=vals: JP.dist_sort_kv(
                JP.shard_1d(jnp.asarray(k), m),
                JP.shard_1d(jnp.asarray(v), m), m), WORLD)
    keys = np.full(1 << 12, 3, dtype=np.uint32)
    cases["dist_sort_balanced_shards"] = (
        (TP.dist_sort, (keys,), {}, None),
        lambda m, k=keys: JP.dist_sort(JP.shard_1d(jnp.asarray(k), m), m),
        WORLD)
    for r, group in ((4, 0), (8, 1)):
        keys = _keys(_rng(), 1 << 13)
        cases[f"dist_histogram-{r}-{group}"] = (
            (TP.dist_digit_histogram, (keys, r, group), {}, None),
            lambda m, k=keys, r=r, g=group: JP.dist_digit_histogram(
                JP.shard_1d(jnp.asarray(k), m), r, g, m), WORLD)
    keys = (_rng(8).standard_normal(1 << 12) * 1e3).astype(np.float32)
    cases["dist_sort_f32_descending"] = (
        (TP.dist_sort, (keys,), {"descending": True}, None),
        lambda m, k=keys: JP.dist_sort(JP.shard_1d(jnp.asarray(k), m), m,
                                       descending=True), WORLD)
    n = 1 << 12
    keys = _rng(9).integers(-40, 40, n, dtype=np.int64).astype(np.int32)
    vals = np.arange(n, dtype=np.uint32)
    cases["dist_sort_kv_i32"] = (
        (TP.dist_sort_kv, (keys, vals), {}, None),
        lambda m, k=keys, v=vals: JP.dist_sort_kv(
            JP.shard_1d(jnp.asarray(k), m), JP.shard_1d(jnp.asarray(v), m),
            m), WORLD)
    merge = {"engine": "merge", "tile_log2": TILE}
    for kind in ("uniform", "all_equal"):
        keys = SKEWS[kind](_rng(), 1 << 13)
        cases[f"dist_sort_merge_engine-{kind}"] = (
            (TP.dist_sort, (keys,), merge, None),
            lambda m, k=keys: JP.dist_sort(JP.shard_1d(jnp.asarray(k), m), m,
                                           engine="merge", tile_log2=7),
            WORLD)
    n = 1 << 13
    keys, vals = SKEWS["few_uniques"](_rng(), n), np.arange(n, dtype=np.uint32)
    cases["dist_sort_kv_merge_engine_stable"] = (
        (TP.dist_sort_kv, (keys, vals), merge, None),
        lambda m, k=keys, v=vals: JP.dist_sort_kv(
            JP.shard_1d(jnp.asarray(k), m), JP.shard_1d(jnp.asarray(v), m),
            m, engine="merge", tile_log2=7), WORLD)
    rng = _rng()
    keys = SKEWS["few_uniques"](rng, n)
    vals = rng.standard_normal(n).astype(np.float32)
    cases["dist_sort_kv_merge_engine_f32_payload"] = (
        (TP.dist_sort_kv, (keys, vals), merge, None),
        lambda m, k=keys, v=vals: JP.dist_sort_kv(
            JP.shard_1d(jnp.asarray(k), m), JP.shard_1d(jnp.asarray(v), m),
            m, engine="merge", tile_log2=7), WORLD)
    n = 1 << 12
    keys, vals = SKEWS["few_uniques"](_rng(), n), np.arange(n, dtype=np.uint32)
    cases["dist_sort_d1_degenerate_mesh"] = (
        (TP.dist_sort, (keys,), {}, 1),
        lambda m, k=keys: JP.dist_sort(jnp.asarray(k), m), 1)
    cases["dist_sort_kv_d1_degenerate_mesh"] = (
        (TP.dist_sort_kv, (keys, vals), {}, 1),
        lambda m, k=keys, v=vals: JP.dist_sort_kv(jnp.asarray(k),
                                                  jnp.asarray(v), m), 1)
    return cases


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


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax(port, case):
    _, jax_call, d = CASES[case]
    want = _outputs(jax_call(JP.make_mesh(d)))
    assert all(x is None for x in port[case][d:])    # outside the mesh
    got = [_outputs(g) for g in port[case][:d]]
    if case.startswith("dist_histogram"):
        for rank, g in enumerate(got):     # replicated on every rank
            np.testing.assert_array_equal(_bits(g[0]), _bits(want[0]),
                                          f"rank {rank}")
        return
    for i, w in enumerate(want):           # whole shards, in rank order
        np.testing.assert_array_equal(
            np.concatenate([_bits(g[i]) for g in got]), _bits(w),
            f"output {i}")
        assert np.asarray(got[0][i]).dtype == np.asarray(w).dtype


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process, torn down after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.make_mesh()
    with pytest.raises(ValueError, match="needs a device"):
        TP.make_mesh(backend="gloo")
    assert not dist.is_initialized()


def test_make_mesh_world_of_one_and_shard_1d(world_of_one):
    mesh = TP.make_mesh(backend="gloo", device="cpu")
    assert (mesh.size, mesh.rank, mesh.member, mesh.group) == (1, 0, True,
                                                               None)
    assert mesh.axis == JP.mesh.DATA_AXIS
    again = TP.make_mesh(1, backend="gloo", device="cpu")   # reused world
    assert again.size == 1 and dist.get_world_size() == 1
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        TP.make_mesh(2, backend="gloo", device="cpu")
    x = np.arange(12, dtype=np.uint32)
    s = TP.shard_1d(x, mesh)
    assert s.dtype == torch.uint32 and s.shape == (12,)
    np.testing.assert_array_equal(s.view(torch.int32).numpy(),
                                  x.view(np.int32))


def test_launch_reports_a_failing_rank():
    # 3 rows do not shard over 2 ranks: each rank raises, the parent says so
    bad = [(TP.dist_sort, (np.arange(3, dtype=np.uint32),), {}, None)]
    with pytest.raises(RuntimeError, match="must be divisible by mesh size"):
        launch.run(2, launch.run_cases, bad, backend="gloo", device="cpu")
