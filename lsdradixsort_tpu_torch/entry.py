"""Entry points of the port — the counterparts of ``__graft_entry__``:
`entry()`, the flagship stable key-value sort step with example
arguments, and `dryrun_multichip(n)`, the whole distributed operator set
over a world of n processes (parallel/launch.py), each step verified
against the golden models."""
from __future__ import annotations

import numpy as np
import torch

from lsdradixsort_tpu_torch.core.convert import to_numpy
from lsdradixsort_tpu_torch.core.datagen import random_kv
from lsdradixsort_tpu_torch.ops.sort import sort_kv


def entry(device="cuda"):
    """Return (step, args): `step(keys, values)` is `sort_kv`, and args are
    2^20 uniform uint32 keys with their row ids as values, on `device`."""
    keys, values = random_kv(1 << 20, seed=0, device=device)

    def step(k, v):
        return sort_kv(k, v)

    return step, (keys, values)


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     device=None) -> None:
    """Run the full distributed operator set on a world of n_devices
    processes (one a card by default; backend and device as in
    parallel/mesh.py `make_mesh`), at the sizes and seeds of the JAX
    package's dryrun, each step verified bit for bit against the golden
    models or numpy:

      1. dist_sort_kv at 2^16 rows a rank, on the merge engine whatever
         the device;
      2. dist_group_by_sum (big groups straddle rank boundaries);
      3. dist_join (unique build keys; probe runs cross ranks);
      4. dist_filter_kv;
      5. dist_join_multi (duplicate build keys: the fragment join);
      6. dist_top_k.

    Raises if any rank fails; prints rank 0's line for each step."""
    from lsdradixsort_tpu_torch.parallel import launch
    lines = launch.run(n_devices, _dryrun_rank, backend=backend,
                       device=device)[0]
    for line in lines:
        print(line)


def _dryrun_rank(mesh) -> list[str] | None:
    """One rank of `dryrun_multichip`: every rank draws the same inputs
    from seed 0 and runs each op on its shards; rank 0 checks the
    gathered outputs and returns its report lines."""
    from lsdradixsort_tpu_torch.golden import (hash_join_multi,
                                               lsd_radix_sort_kv)
    from lsdradixsort_tpu_torch.parallel import (dist_filter_kv,
                                                 dist_group_by_sum,
                                                 dist_join, dist_join_multi,
                                                 dist_sort_kv, dist_top_k,
                                                 shard_1d, undistribute)

    d = mesh.size
    tag = f"dryrun_multichip({d})"
    rng = np.random.default_rng(0)
    check = mesh.rank == 0
    lines = []

    def sh(*arrays):
        return [shard_1d(a, mesh) for a in arrays]

    # 1. distributed stable kv sort, 2^16 rows a rank
    n = (1 << 16) * d
    keys = rng.integers(0, 1 << 20, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    ok, ov = dist_sort_kv(*sh(keys, vals), mesh, engine="merge")
    whole = torch.full((1,), n // d, dtype=torch.int32,
                       device=mesh.device).view(torch.uint32)
    _, gk, gv = undistribute(whole, ok, ov, mesh=mesh)
    if check:
        wk, wv = lsd_radix_sort_kv(keys, vals)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)
        lines.append(f"{tag}: distributed stable kv-sort of {n} rows "
                     f"(merge engine) verified bit-exact against the "
                     f"golden model")

    # 2. distributed GROUP BY SUM (big groups straddle rank boundaries)
    ng = 1 << 14
    gk_np = rng.integers(0, 300, ng, dtype=np.uint64).astype(np.uint32)
    gv_np = rng.integers(0, 1 << 16, ng, dtype=np.uint64).astype(np.uint32)
    total, ck, cs = undistribute(*dist_group_by_sum(*sh(gk_np, gv_np),
                                                    mesh=mesh), mesh=mesh)
    if check:
        uk = np.unique(gk_np)
        sums = np.zeros_like(uk, dtype=np.uint32)
        np.add.at(sums, np.searchsorted(uk, gk_np), gv_np)
        assert total == uk.size, (total, uk.size)
        np.testing.assert_array_equal(ck, uk.astype(np.uint32))
        np.testing.assert_array_equal(cs, sums)
        lines.append(f"{tag}: distributed group-by of {ng} rows -> {total} "
                     f"groups verified")

    # 3. distributed join (unique build keys; probe runs cross ranks)
    nb, npr = 1 << 9, 1 << 13
    bk = rng.permutation(1 << 10)[:nb].astype(np.uint32)
    bv = rng.integers(0, 1 << 30, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 1 << 10, npr, dtype=np.uint64).astype(np.uint32)
    pv = rng.integers(0, 1 << 30, npr, dtype=np.uint64).astype(np.uint32)
    total, ck, cpv, cbv, cpos = undistribute(
        *dist_join(*sh(bk, bv, pk, pv), mesh=mesh), mesh=mesh)
    if check:
        lut = dict(zip(bk.tolist(), bv.tolist()))
        rows = [(i, kk, vv, lut[kk]) for i, (kk, vv) in
                enumerate(zip(pk.tolist(), pv.tolist())) if kk in lut]
        assert total == len(rows), (total, len(rows))
        got = sorted(zip(cpos.tolist(), ck.tolist(), cpv.tolist(),
                         cbv.tolist()))
        assert got == sorted(rows)
        lines.append(f"{tag}: distributed join of {npr} probe x {nb} build "
                     f"rows -> {total} matches verified")

    # 4. distributed range filter (rank-local streaming compaction)
    nf = (1 << 12) * d
    fk_np = rng.integers(0, 1 << 20, nf, dtype=np.uint64).astype(np.uint32)
    fv_np = np.arange(nf, dtype=np.uint32)
    lo, hi = np.uint32(1 << 18), np.uint32(3 << 18)
    total, ck, cv = undistribute(
        *dist_filter_kv(*sh(fk_np, fv_np), lo, hi, mesh), mesh=mesh)
    if check:
        mask = (fk_np >= lo) & (fk_np < hi)
        assert total == int(mask.sum()), (total, int(mask.sum()))
        np.testing.assert_array_equal(ck, fk_np[mask])
        np.testing.assert_array_equal(cv, fv_np[mask])
        lines.append(f"{tag}: distributed range filter of {nf} rows -> "
                     f"{total} kept rows verified")

    # 5. distributed many-to-many join (duplicate build keys; probes
    # replicated to every rank whose build fragment holds their key)
    nb2, npr2 = 1 << 9, 1 << 12
    bk2 = rng.integers(0, 100, nb2, dtype=np.uint64).astype(np.uint32)
    bv2 = rng.integers(0, 1 << 30, nb2, dtype=np.uint64).astype(np.uint32)
    pk2 = rng.integers(0, 150, npr2, dtype=np.uint64).astype(np.uint32)
    pv2 = rng.integers(0, 1 << 30, npr2, dtype=np.uint64).astype(np.uint32)
    total, ck, cpos, cpv, cbv, cbr = undistribute(
        *dist_join_multi(*sh(bk2, bv2, pk2, pv2), mesh=mesh,
                         max_out=1 << 14), mesh=mesh)
    if check:
        gk, gpv, gbv = hash_join_multi(bk2, bv2, pk2, pv2)
        assert total == gk.size, (total, gk.size)
        order = np.lexsort((cbr, cpos))
        np.testing.assert_array_equal(ck[order], gk)
        np.testing.assert_array_equal(cpv[order], gpv)
        np.testing.assert_array_equal(cbv[order], gbv)
        lines.append(f"{tag}: distributed many-to-many join of {npr2} probe "
                     f"x {nb2} build rows -> {total} matches verified")

    # 6. distributed top-k (local top_k + candidate gather)
    nt = (1 << 12) * d
    tk_np = rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32)
    kq = 32
    tv, ti = dist_top_k(*sh(tk_np), kq, mesh=mesh)
    if check:
        worder = np.argsort(~tk_np, kind="stable")[:kq]
        np.testing.assert_array_equal(to_numpy(tv), tk_np[worder])
        np.testing.assert_array_equal(to_numpy(ti), worder.astype(np.uint32))
        lines.append(f"{tag}: distributed top-{kq} of {nt} rows verified")
    return lines if check else None


def config5_plan(build_keys, build_vals, probe_keys, probe_vals, mesh,
                 lo: int = 0, hi: int = 500):
    """The north star's config-5 plan on one rank of a mesh, each stage
    distributed, with host glue between them: keep the probe
    rows with lo <= value < hi (dist_filter_kv), join them against the
    build table (dist_join), then GROUP BY build value SUM(probe value)
    (dist_group_by_sum). Each stage's ragged output is gathered and
    re-sharded, padded to a multiple of the mesh size with 0xFFFFFFFF
    keys, which match no build key and group apart. Every rank passes its
    shards of the four uint32 columns; returns (groups, keys, sums) as
    numpy arrays, on every rank."""
    from lsdradixsort_tpu_torch.parallel import (dist_filter_kv,
                                                 dist_group_by_sum,
                                                 dist_join, shard_1d,
                                                 undistribute)
    d = mesh.size

    def reshard(keys, vals):
        pad = -keys.size % d
        return (shard_1d(np.pad(keys, (0, pad), constant_values=0xFFFFFFFF),
                         mesh),
                shard_1d(np.pad(vals, (0, pad)), mesh))

    _, fk, fv = undistribute(*dist_filter_kv(probe_keys, probe_vals, lo, hi,
                                             mesh), mesh=mesh)
    _, _, mpv, mbv, _ = undistribute(
        *dist_join(build_keys, build_vals, *reshard(fk, fv), mesh=mesh),
        mesh=mesh)
    return undistribute(*dist_group_by_sum(*reshard(mbv, mpv), mesh=mesh),
                        mesh=mesh)
