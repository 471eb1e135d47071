"""Benchmark suite runner — the port of lsdradixsort_tpu/bench/runner.py.

The reference fuses testing and benchmarking: each Test* function times the
CPU golden, times the GPU kernels, verifies element-by-element, and prints a
per-config report; main() sweeps configs behind compile-time #defines
(LSDRadixSort.cu:912-1185). Here the same discipline is a CLI on one CUDA
card:

    python -m lsdradixsort_tpu_torch.bench sort --n 27 --verify
    python -m lsdradixsort_tpu_torch.bench histogram --n 27 --sweep
    python -m lsdradixsort_tpu_torch.bench all --n 24 --verify --out report

The suites, record names, config keys, bytes moved and sweep lists are the
JAX runner's; `--verify` checks every record against the port's numpy golden
models (golden/) and numpy, bit for bit. Every record carries achieved GB/s
and its fraction of the card's copy ceiling (core/roofline.py); `main`
prints the card's name and power limit, and the JSON report carries them
(`card`). Device times are the port's CUDA-event medians (core/timing.py
`time_fn`), which raise without a card: there is no CPU fallback. The
suites make their data on the card from `torch.Generator` seeds; only tests
pass `device="cpu"` (with a host timer patched in).

`dist` runs the distributed kv-sort (parallel/) over the process group
`make_mesh` finds or makes: a world of one on the card unless the CLI is
started under torchrun. `--no-cache` is accepted and ignored: the port
has no compilation cache to disable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from lsdradixsort_tpu_torch.core import datagen, roofline
from lsdradixsort_tpu_torch.core.convert import iota_u32, to_numpy
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn, time_host
from lsdradixsort_tpu_torch.utils.verify import check_arrays


@dataclasses.dataclass
class Record:
    suite: str
    config: dict
    device_ms: float
    melems_per_s: float
    gbytes_per_s: float
    roofline_frac: float
    host_ms: float | None = None
    speedup_vs_host: float | None = None
    verified: bool | None = None

    def line(self) -> str:
        s = (f"[{self.suite}] {self.config} : {self.device_ms:.3f} ms, "
             f"{self.melems_per_s:.1f} Melem/s, {self.gbytes_per_s:.1f} GB/s "
             f"({100 * self.roofline_frac:.1f}% of roofline)")
        if self.speedup_vs_host is not None:
            s += f", x{self.speedup_vs_host:.2f} vs host"
        if self.verified is not None:
            s += ", verified" if self.verified else ", VERIFY FAILED"
        return s


# --budget deadline, enforced at this single choke point: once exceeded,
# remaining configs are SKIPPED LOUDLY (printed + recorded in the report's
# "skipped" list — a silent cap would read as full coverage)
_DEADLINE: float | None = None
_SKIPPED: list[dict] = []


def set_budget(seconds: float | None) -> None:
    global _DEADLINE
    _DEADLINE = None if seconds is None else time.time() + seconds
    _SKIPPED.clear()


def _bench(suite, config, fn, args, n, bytes_moved, host_fn=None,
           host_args=None, verify=None, iters=5) -> Record | None:
    if _DEADLINE is not None and time.time() > _DEADLINE:
        _SKIPPED.append({"suite": suite, "config": config})
        print(f"[{suite}] {config} : SKIPPED (budget exhausted)", flush=True)
        return None
    rl = roofline.detect()
    t = time_fn(fn, *args, iters=iters)
    rec = Record(
        suite=suite, config=config, device_ms=t.ms,
        melems_per_s=n / t.seconds / 1e6,
        gbytes_per_s=bytes_moved / t.seconds / 1e9,
        roofline_frac=rl.fraction(bytes_moved, t.seconds),
    )
    if host_fn is not None:
        th = time_host(host_fn, *host_args)
        rec.host_ms = th.ms
        rec.speedup_vs_host = th.seconds / t.seconds
    if verify is not None:
        try:
            verify()
            rec.verified = True
        except AssertionError:
            rec.verified = False
    return rec


def _check_prefix(count, got, want) -> None:
    """A (count, *columns) result whose first `count` rows are defined,
    against numpy columns."""
    assert int(count) == want[0].size, (int(count), want[0].size)
    for g, w in zip(got, want, strict=True):
        check_arrays(to_numpy(g)[:w.size], w)


# ---------------------------------------------------------------------------
# Suites (mirror the reference's Benchmark* sweeps, cu:1064-1150)
# ---------------------------------------------------------------------------

def suite_sort(n_log2: int, verify: bool, sweep: bool,
               device="cuda") -> list[Record]:
    from lsdradixsort_tpu_torch import native
    from lsdradixsort_tpu_torch.bench.flagship import sort64_keys
    from lsdradixsort_tpu_torch.ops.sort import (merge_sort_keys,
                                                 merge_sort_with_ranks,
                                                 sort, sort64_with_ranks,
                                                 sort_kv)
    n = 1 << n_log2
    keys = datagen.random_keys(n, device=device)
    keys_np = to_numpy(keys)
    perm = np.argsort(keys_np, kind="stable") if verify else None
    out = []

    def check_ranks(f, keys_np=keys_np, perm=perm):
        sk, sv = f()
        check_arrays(to_numpy(sk), keys_np[perm])
        check_arrays(to_numpy(sv), perm.astype(np.uint32))

    # the framework sort (strategy="merge", the default) vs torch.sort
    fn = sort
    fx = lambda k: sort(k, strategy="xla")
    ver = verx = None
    host_fn = host_args = None
    if native.available():
        # host baseline: the reference's CPU-golden timing (cu:984-990)
        host_fn = lambda: native.radix_sort(keys_np)
        host_args = ()
    if verify:
        ver = lambda: check_arrays(to_numpy(fn(keys)), keys_np[perm])
        verx = lambda: check_arrays(to_numpy(fx(keys)), keys_np[perm])
    out.append(_bench("sort/keys", {"n": n, "strategy": "merge"}, fn,
                      (keys,), n, bytes_moved=8 * n, host_fn=host_fn,
                      host_args=host_args, verify=ver))
    out.append(_bench("sort/keys_xla", {"n": n}, fx, (keys,), n,
                      bytes_moved=8 * n, verify=verx))
    # f32 keys through the order-preserving codec (core/keycodec.py):
    # prices the encode/decode overhead on the same engine
    fkeys = ((datagen.random_keys(n, seed=3, device=device)
              .view(torch.int32) >> 9) & 0x7FFFFF).view(torch.float32) + 1.0
    vf = None
    if verify:
        fkeys_np = to_numpy(fkeys)
        vf = lambda: check_arrays(to_numpy(sort(fkeys)), np.sort(fkeys_np))
    out.append(_bench("sort/keys_f32", {"n": n, "strategy": "merge"}, sort,
                      (fkeys,), n, bytes_moved=8 * n, verify=vf))
    vals = iota_u32(n, device)
    # explicit strategy="xla": sort_kv's default is the merge engine
    fkv = lambda k, v: sort_kv(k, v, strategy="xla")
    vkv = vmr = None
    if verify:
        vkv = lambda: check_ranks(lambda: fkv(keys, vals))
        vmr = lambda: check_ranks(lambda: merge_sort_with_ranks(keys))
    out.append(_bench("sort/kv", {"n": n, "strategy": "xla"}, fkv,
                      (keys, vals), n, bytes_moved=16 * n, verify=vkv))
    out.append(_bench("sort/kv_merge", {"n": n}, merge_sort_with_ranks,
                      (keys,), n, bytes_moved=16 * n, verify=vmr))
    if sweep:
        # tile/buffer geometry A/B of the JAX runner: the buffer is a TPU
        # knob the port ignores; the tile size is real
        for tl, bl in ((15, 19), (18, 20), (18, 19)):
            fg = lambda k, t=tl, b=bl: merge_sort_keys(k, tile_log2=t,
                                                       max_buf=1 << b)
            fgkv = lambda k, t=tl, b=bl: merge_sort_with_ranks(
                k, tile_log2=t, max_buf=1 << b)
            vg = vgkv = None
            if verify:
                vg = lambda f=fg: check_arrays(to_numpy(f(keys)),
                                               keys_np[perm])
                vgkv = lambda f=fgkv: check_ranks(lambda: f(keys))
            out.append(_bench(f"sort/keys_t{tl}_b{bl}", {"n": n}, fg,
                              (keys,), n, bytes_moved=8 * n, verify=vg))
            out.append(_bench(f"sort/kv_t{tl}_b{bl}", {"n": n}, fgkv,
                              (keys,), n, bytes_moved=16 * n, verify=vgkv))
        # 64-bit keys: single-chain (hi, lo, pos) ncmp=3 engine vs the
        # two-pass spelling vs two stable torch.sorts
        hi64 = datagen.random_keys(n, seed=11, device=device)
        lo64 = datagen.random_keys(n, seed=12, device=device)
        if verify:
            wh, wl, widx = sort64_keys(hi64, lo64)
            want64 = [to_numpy(wh.view(torch.uint32)),
                      to_numpy(wl.view(torch.uint32)),
                      widx.cpu().numpy().astype(np.uint32)]
            del wh, wl, widx
        for strat in ("merge", "merge2", "xla"):
            f64 = lambda h, l, s=strat: sort64_with_ranks(h, l, strategy=s)
            v64 = None
            if verify:
                def v64(f=f64):
                    for g, w in zip(f(hi64, lo64), want64, strict=True):
                        check_arrays(to_numpy(g), w)
            out.append(_bench(f"sort/64bit_{strat}", {"n": n}, f64,
                              (hi64, lo64), n, bytes_moved=24 * n,
                              verify=v64))
        # the composed LSD radix pipeline (histogram -> scans -> scatter,
        # the reference's pass structure)
        nc = min(n, 1 << 24)
        ckeys = keys[:nc]
        cfn = lambda k: sort(k, strategy="composed")
        cver = None
        if verify:
            cver = lambda: check_arrays(to_numpy(cfn(ckeys)),
                                        np.sort(keys_np[:nc]))
        out.append(_bench("sort/composed_r8", {"n": nc}, cfn, (ckeys,), nc,
                          bytes_moved=8 * nc, verify=cver, iters=2))
    return out


def suite_tile_sort(n_log2: int, verify: bool, sweep: bool,
                    device="cuda") -> list[Record]:
    """Block-local stable kv sort (TestLSDBinaryRadixSort analog,
    cu:423-477)."""
    from lsdradixsort_tpu_torch.kernels.tile_sort import sort_tiles_kv
    n = 1 << n_log2
    keys = datagen.random_keys(n, device=device)
    vals = iota_u32(n, device)
    rows_opts = (16, 64, 128, 512) if sweep else (128,)
    out = []
    for rows in rows_opts:
        tile = rows * 128
        if n % tile:
            continue
        fn = lambda k, v, r=rows: sort_tiles_kv(k, v, tile_rows=r)
        ver = None
        if verify:
            keys_np = to_numpy(keys)

            def ver(f=fn, t=tile, keys_np=keys_np):
                sk, sv = (to_numpy(o) for o in f(keys, vals))
                segs = keys_np.reshape(-1, t)
                p = np.argsort(segs, axis=1, kind="stable")
                check_arrays(sk, np.take_along_axis(segs, p, 1).ravel())
                check_arrays(sv, (p + np.arange(0, n, t)[:, None]).astype(
                    np.uint32).ravel())
        out.append(_bench("tile_sort", {"n": n, "tile": tile}, fn,
                          (keys, vals), n, bytes_moved=16 * n, verify=ver))
    return out


def suite_shuffle(n_log2: int, verify: bool, sweep: bool,
                  device="cuda") -> list[Record]:
    """Run-shuffle bandwidth (the radix scatter's data movement)."""
    from lsdradixsort_tpu_torch.kernels.shuffle import shuffle_row_runs
    n = 1 << n_log2
    rows = n // 128
    x = datagen.random_keys(n, device=device).view(rows, 128)
    run_opts = (8, 32, 128, 512) if sweep else (32, 128)
    out = []
    for run in run_opts:
        nch = rows // run
        src = torch.arange(nch, dtype=torch.int32, device=device) * run
        dst = (nch - 1 - torch.arange(nch, dtype=torch.int32,
                                      device=device)) * run
        lens = torch.full((nch,), run, dtype=torch.int32, device=device)
        fn = lambda a, s, d, l, r=run: shuffle_row_runs(
            a, s, d, l, out_rows=rows, fixed_rows=r)
        ver = None
        if verify:
            xs = to_numpy(x)

            def ver(f=fn, run=run, xs=xs, s=src, d=dst, l=lens):
                got = to_numpy(f(x, s, d, l))
                want = xs.reshape(-1, run, 128)[::-1].reshape(rows, 128)
                check_arrays(got, want)
        out.append(_bench("shuffle", {"rows": rows, "run_rows": run,
                                      "run_kb": run * 128 * 4 // 1024},
                          fn, (x, src, dst, lens), n, bytes_moved=8 * n,
                          verify=ver))
    return out


def suite_histogram(n_log2: int, verify: bool, sweep: bool,
                    device="cuda") -> list[Record]:
    from lsdradixsort_tpu_torch import golden
    from lsdradixsort_tpu_torch.kernels.histogram import block_digit_histograms
    n = 1 << n_log2
    keys = datagen.random_keys(n, device=device)
    rs = (1, 2, 4, 8) if sweep else (4, 8)
    blocks = (1 << 13, 1 << 15, 1 << 17) if sweep else (1 << 15,)
    cbs = (8, 4) if sweep else (8,)
    keys_np = to_numpy(keys) if verify else None
    out = []
    for r in rs:
        for block in blocks:
            if n % block:
                continue
            for cb in cbs:
                fn = lambda k, r=r, b=block, cb=cb: block_digit_histograms(
                    k, r, 0, b, counter_bits=cb)
                ver = None
                if verify:
                    ver = lambda r=r, b=block, f=fn: check_arrays(
                        to_numpy(f(keys)),
                        golden.digit_histograms(keys_np, r, 0, b))
                out.append(_bench(
                    "histogram", {"n": n, "r": r, "block": block, "cb": cb},
                    fn, (keys,), n, bytes_moved=4 * n, verify=ver))
    return out


def suite_scan(n_log2: int, verify: bool, sweep: bool,
               device="cuda") -> list[Record]:
    from lsdradixsort_tpu_torch import golden
    from lsdradixsort_tpu_torch.kernels.scan import (
        exclusive_scan, exclusive_scan_hierarchical)
    n = 1 << n_log2
    a = datagen.random_keys(n, device=device)
    want = golden.prefix_sum(to_numpy(a)) if verify else None
    out = []
    rows_options = (128, 256, 512, 1024) if sweep else (512,)
    for rows in rows_options:
        for name, kern in (("scan/carry", exclusive_scan),
                           ("scan/hier", exclusive_scan_hierarchical)):
            fn = lambda x, k=kern, rows=rows: k(x, block_rows=rows)
            ver = None
            if verify:
                ver = lambda f=fn: check_arrays(to_numpy(f(a)), want)
            out.append(_bench(name, {"n": n, "block_rows": rows}, fn, (a,),
                              n, bytes_moved=8 * n, verify=ver))
    return out


def suite_transpose(n_log2: int, verify: bool, sweep: bool,
                    device="cuda") -> list[Record]:
    """Matrix transpose (TestTranspose analog, cu:546-637): the plain
    `transpose`, as the JAX suite times XLA's (the tiled kernel is timed
    by chip_smoke.py)."""
    from lsdradixsort_tpu_torch.kernels.transpose import transpose
    n = 1 << n_log2
    shapes = [(1 << (n_log2 // 2), n >> (n_log2 // 2))]
    if sweep:
        shapes += [(256, n // 256), (n // 256, 256)]
    out = []
    for rows, cols in shapes:
        a = datagen.random_keys(n, device=device).view(rows, cols)
        ver = None
        if verify:
            a_np = to_numpy(a)
            ver = lambda a=a, a_np=a_np: check_arrays(to_numpy(transpose(a)),
                                                      a_np.T)
        out.append(_bench("transpose", {"rows": rows, "cols": cols},
                          transpose, (a,), n, bytes_moved=8 * n, verify=ver))
    return out


def suite_query(n_log2: int, verify: bool, sweep: bool,
                device="cuda") -> list[Record]:
    """filter + aggregate + join — north star configs 3-4: the ops and
    data of bench/query.py at n = 2^n_log2, nb = n / 10, each verified
    against the golden models and numpy as the JAX suite does."""
    from lsdradixsort_tpu_torch import golden
    from lsdradixsort_tpu_torch.bench import query as Q
    n = 1 << n_log2
    nb = max(n // 10, 1)
    d = Q.make_data(device, n, nb)
    ops = {Q.label(op): op for op in Q.query_ops(d)}
    np_cols = {k: to_numpy(v) for k, v in d.items()
               if isinstance(v, torch.Tensor)} if verify else {}

    def cols(*names):
        return [np_cols[k] for k in names]

    def in_range():
        k = np_cols["keys"]
        return (k >= Q.LO) & (k < Q.HI)

    def want_filter():
        k, v = cols("keys", "vals")
        m = in_range()
        return [k[m], v[m]]

    def want_groups():
        return list(golden.group_by_sum(*cols("keys", "vals")))

    def want_filtered_groups():
        g, v = cols("gkeys", "vals")
        m = in_range()
        return list(golden.group_by_sum(g[m], v[m]))

    def want_join():
        return list(golden.hash_join(*cols("bkeys", "bvals", "pkeys",
                                           "vals")))

    def want_join_multi():
        return list(golden.hash_join_multi(*cols("bkeys_m", "bvals", "pkeys",
                                                 "vals")))

    def want_vmem_join():
        return list(golden.hash_join(*cols("bkeys_s", "bvals_s", "pkeys_s",
                                           "vals")))

    def want_in_set():
        p, v, b = cols("pkeys_s", "vals", "bkeys_s")
        m = np.isin(p, b)
        return [p[m], v[m]]

    def check_top_k(out):
        t = np_cols["tkeys"]
        order = np.argsort(~t, kind="stable")[:Q.TOP_K]
        check_arrays(to_numpy(out[0]), t[order])
        check_arrays(to_numpy(out[1]), order.astype(np.uint32))

    def check_unique(out):
        uk, cts = np.unique(np_cols["keys"], return_counts=True)
        _check_prefix(out[0], out[1:], [uk, cts.astype(np.uint32)])

    max_out = 2 * n

    def check_join_multi(out):
        want = want_join_multi()
        assert int(out[0]) == want[0].size
        m = min(want[0].size, max_out)
        for g, w in zip(out[1:], want, strict=True):
            check_arrays(to_numpy(g)[:m], w[:m])

    def prefix(want_fn):
        return lambda out: _check_prefix(out[0], out[1:], want_fn())

    join_cfg = {"build": nb, "probe": n}
    join_bytes = 8 * (n + nb) + 24 * n
    # (record, op of bench/query.py, config, bytes moved, check, sweep only)
    table = [
        ("query/filter", "filter_kv", {"n": n}, 16 * n, prefix(want_filter),
         False),
        ("query/group_by_sum", "group_by_sum xla", {"n": n}, 16 * n,
         prefix(want_groups), False),
        ("query/group_by_sum_merge", "group_by_sum merge", {"n": n}, 16 * n,
         prefix(want_groups), True),
        ("query/filtered_group_by (config 3)", "filtered_group_by_sum xla",
         {"n": n}, 20 * n, prefix(want_filtered_groups), False),
        ("query/filtered_group_by_merge", "filtered_group_by_sum merge",
         {"n": n}, 20 * n, prefix(want_filtered_groups), True),
        ("query/hash_join", "hash_join xla", join_cfg, join_bytes,
         prefix(want_join), False),
        ("query/hash_join_merge", "hash_join merge", join_cfg, join_bytes,
         prefix(want_join), True),
        ("query/hash_join_multi", "hash_join_multi xla",
         {**join_cfg, "max_out": max_out},
         8 * (n + nb) + 24 * max_out, check_join_multi, False),
        ("query/hash_join_multi_merge", "hash_join_multi merge",
         {**join_cfg, "max_out": max_out},
         8 * (n + nb) + 24 * max_out, check_join_multi, True),
        ("query/hash_join_vmem_small", "hash_join vmem",
         {"build": Q.SMALL_BUILD, "probe": n}, 16 * n,
         prefix(want_vmem_join), False),
        ("query/filter_in_set", "filter_in_set",
         {"set": Q.SMALL_BUILD, "n": n}, 16 * n, prefix(want_in_set), False),
        ("query/top_k", "top_k", {"n": n, "k": Q.TOP_K}, 8 * n, check_top_k,
         False),
        ("query/unique", "unique", {"n": n}, 16 * n, check_unique, False),
    ]
    out = []
    for name, op_label, config, nbytes, check, sweep_only in table:
        if sweep_only and not sweep:
            continue
        run = ops[op_label].run
        ver = (lambda run=run, check=check: check(run())) if verify else None
        out.append(_bench(name, config, run, (), n, bytes_moved=nbytes,
                          verify=ver))
    return out


def suite_dist(n_log2: int, verify: bool, sweep: bool,
               device="cuda") -> list[Record]:
    """Distributed kv-sort over the mesh's processes (north-star config
    5): D = the mesh's size, each rank timing its own call. At D > 1 the
    record carries the scaling efficiency against the one-device stable
    sort with positions (`sort_with_ranks`); at D = 1 the ratio is the
    dist machinery's overhead over that sort, not scaling, and is
    labelled so. Every rank builds the same keys and verifies its own
    shard. The JAX runner caps n at 2^22 when D = 1, for a TPU compile
    helper's crash; the port has no such cap."""
    from lsdradixsort_tpu_torch.ops.sort import sort_with_ranks
    from lsdradixsort_tpu_torch.parallel import (dist_sort_kv, make_mesh,
                                                 shard_1d)
    mesh = (make_mesh() if torch.device(device).type == "cuda"
            else make_mesh(backend="gloo", device=device))
    d = mesh.size
    n = 1 << n_log2
    keys = datagen.random_keys(n, device=device)
    sk = shard_1d(keys, mesh)
    sv = shard_1d(iota_u32(n, device), mesh)
    fn = lambda k, v: dist_sort_kv(k, v, mesh)
    ver = None
    if verify:
        keys_np = to_numpy(keys)
        perm = np.argsort(keys_np, kind="stable")
        mine = slice(mesh.rank * (n // d), (mesh.rank + 1) * (n // d))

        def ver():
            ok, ov = fn(sk, sv)
            check_arrays(to_numpy(ok), keys_np[perm][mine])
            check_arrays(to_numpy(ov), perm[mine].astype(np.uint32))
    out = [_bench("dist/sort_kv", {"n": n, "devices": d}, fn, (sk, sv), n,
                  bytes_moved=16 * n, verify=ver)]
    rec = out[0]
    if rec is None:                 # budget-skipped
        return out
    # the one-device reference, as a field of the dist record
    t1 = time_fn(sort_with_ranks, keys, iters=5)
    ratio = t1.seconds / rec.device_ms * 1e3
    if d > 1:
        eff = ratio / d
        rec.config["scaling_eff"] = round(eff, 4)
        print(f"# scaling efficiency vs 1-device sort_with_ranks: "
              f"{100 * eff:.1f}% at D={d}")
    else:
        rec.config["d1_dist_overhead"] = round(1.0 / ratio, 4)
        print(f"# D=1: dist path costs {1.0 / ratio:.2f}x the local "
              f"sort_with_ranks (machinery overhead, not scaling)")
    return out


SUITES: dict[str, Callable] = {
    # dist first, as in the JAX runner
    "dist": suite_dist,
    "sort": suite_sort,
    "tile_sort": suite_tile_sort,
    "shuffle": suite_shuffle,
    "histogram": suite_histogram,
    "scan": suite_scan,
    "transpose": suite_transpose,
    "query": suite_query,
}


def run_suite(name: str, n_log2: int = 24, verify: bool = False,
              sweep: bool = False, device="cuda"
              ) -> tuple[list[Record], list[dict]]:
    """Run suites; a crashed suite is recorded in `failed`, not swallowed
    (the reference only skips *known-infeasible* configs with a printed
    reason, cu:940-964 — the sweep goes on, but the failure shows in the
    report and the exit code)."""
    names = list(SUITES) if name == "all" else [name]
    records: list[Record] = []
    failed: list[dict] = []
    for s in names:
        try:
            for rec in SUITES[s](n_log2, verify, sweep, device=device):
                if rec is None:          # budget-skipped config
                    continue
                print(rec.line(), flush=True)
                records.append(rec)
        except Exception as e:
            msg = (str(e).splitlines() or [type(e).__name__])[0][:160]
            failed.append({"suite": s, "error": msg})
            print(f"[{s}] SUITE FAILED: {msg}", flush=True)
    return records, failed


def main(argv=None, device="cuda") -> int:
    """The CLI; `device` is the card unless a test asks for the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("suite", choices=[*SUITES, "all"])
    p.add_argument("--n", type=int, default=24, help="log2 element count")
    p.add_argument("--verify", action="store_true",
                   help="check against golden models (reference discipline)")
    p.add_argument("--sweep", action="store_true",
                   help="sweep block sizes / digit widths like the reference")
    p.add_argument("--out", type=str, default=None,
                   help="write <out>.json and <out>.md reports")
    p.add_argument("--budget", type=float, default=None,
                   help="wall-clock budget in seconds; configs past the "
                        "deadline are skipped loudly and listed in the "
                        "report")
    p.add_argument("--no-cache", action="store_true",
                   help="accepted and ignored (no compilation cache here)")
    args = p.parse_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1
    set_budget(args.budget)
    rl = roofline.detect(device)
    card = card_label()
    print(f"# device: {rl.device_kind} ({card}), roofline {rl.hbm_gbps} GB/s "
          f"(measured copy ceiling; spec {rl.spec_gbps})", flush=True)
    records, failed = run_suite(args.suite, args.n, args.verify, args.sweep,
                                device=device)
    if args.out:
        with open(args.out + ".json", "w") as f:
            json.dump({"records": [dataclasses.asdict(r) for r in records],
                       "failed_suites": failed,
                       "skipped": _SKIPPED,
                       "device": rl.device_kind, "card": card,
                       "roofline_gbps": rl.hbm_gbps,
                       "session": time.strftime("%Y-%m-%d %H:%M")}, f,
                      indent=1)
        with open(args.out + ".md", "w") as f:
            f.write(f"# Benchmark report — {rl.device_kind} ({card}), "
                    f"{time.strftime('%Y-%m-%d')}\n\n")
            for r in records:
                f.write(r.line() + "\n")
            for fl in failed:
                f.write(f"FAILED {fl['suite']}: {fl['error']}\n")
    if dist.is_initialized():       # the dist suite's world
        dist.destroy_process_group()
    # automation keys on the exit code: any verify failure or crashed
    # suite is a nonzero exit
    bad_verify = [r for r in records if r.verified is False]
    return 1 if failed or bad_verify else 0


if __name__ == "__main__":
    sys.exit(main())
