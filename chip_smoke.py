#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lsdradixsort_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: the card's name, its power limit (nvidia-smi), and the build of
   the port's CUDA kernels from the sources in this checkout.
2. Each kernel (tile sorts with 1, 2 and 3 streams at the 2^15-row tile;
   merge passes with 1, 2 and 3 streams at run_len 2^15 and 2^18, and a
   4-run group) against its plain PyTorch version on the card, bit for
   bit, on uniform, all-equal, presorted, reversed, 97-distinct and
   {0, 0xFFFFFFFF} keys, plus the signed-val tiebreak of sort_tiles_kv.
3. The flagship path end to end: merge_sort_keys at 2^27 and 2^27 - 12345
   rows against torch.sort; merge_sort_with_ranks at 2^27 with the
   stability check; the entry() step (sort_kv at 2^20) with u32 and f32
   payloads; sort of i32 and f32 keys, descending.
4. Launch counters: every kernel launched during phase 3, and no plain
   version ran.
5. Each kernel against its plain version at the main path's shapes, bit
   for bit: the tile sorts at n = 2^27 (1, 2 and 3 streams), then every
   merge pass of the chain (run 2^15, 2^18, 2^21, 2^24), each fed the
   kernel's previous output. Times (CUDA events, median of 5 after a
   warm-up): keys and kv at 2^27, torch.sort on the same keys, and each
   of those kernel calls beside its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the port's package beside it, the script fails.
"""
from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1

    from lsdradixsort_tpu_torch.bench.flagship import (check_keys,
                                                       check_ranks,
                                                       torch_sort_u32)
    from lsdradixsort_tpu_torch.core.convert import iota_u32, u32_to_i64
    from lsdradixsort_tpu_torch.core.datagen import (random_keys,
                                                     random_keys_bounded)
    from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
    from lsdradixsort_tpu_torch.entry import entry
    from lsdradixsort_tpu_torch.kernels import _build
    from lsdradixsort_tpu_torch.kernels import merge as M
    from lsdradixsort_tpu_torch.kernels import tile_sort as TS
    from lsdradixsort_tpu_torch.ops.sort import (merge_sort_keys,
                                                 merge_sort_with_ranks, sort)

    dev = torch.device("cuda")
    # ---- 1. device and build ----------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f"device: {name}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  {line.strip()}")

    # ---- 2. kernels against their plain versions ---------------------------
    tile_rows = (1 << 15) // TS.LANES
    n2 = 1 << 22

    def families(n, seed):
        return {
            "uniform": random_keys(n, seed, dev),
            "all_equal": torch.full((n,), 0x5EEDBEEF, dtype=torch.int32,
                                    device=dev).view(torch.uint32),
            "presorted": iota_u32(n, dev),
            "reversed": torch.arange(n - 1, -1, -1, dtype=torch.int32,
                                     device=dev).view(torch.uint32),
            "distinct97": random_keys_bounded(n, 0, 97, seed, dev),
            "extremes": (random_keys_bounded(n, 0, 2, seed, dev)
                         .view(torch.int32).neg().view(torch.uint32)),
        }

    max_err = {k: 0 for k in ("sort_tiles", "sort_tiles_kv",
                              "sort_tiles_multi", "merge_pass_multi")}

    def compare(kernel, label, got, want):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            err = int((u32_to_i64(g) - u32_to_i64(w)).abs().max())
            max_err[kernel] = max(max_err[kernel], err)
            check_keys(g, w, f"{kernel} {label} stream {i}")

    def streams_of(out):
        """A wrapper's output as its list of streams, the key first."""
        if isinstance(out, torch.Tensor):
            return [out]
        k, vs = out
        return [k, *vs] if isinstance(vs, list) else [k, vs]

    iota = iota_u32(n2, dev)
    pay = random_keys(n2, 2, dev)
    for fam, x in families(n2, 1).items():
        compare("sort_tiles", fam, streams_of(TS.sort_tiles(x, tile_rows)),
                streams_of(TS.sort_tiles_plain(x, tile_rows)))
        compare("sort_tiles_kv", fam,
                streams_of(TS.sort_tiles_kv(x, iota, tile_rows)),
                streams_of(TS.sort_tiles_kv_plain(x, iota, tile_rows)))
        for vals in ([pay], [iota, pay]):
            compare("sort_tiles_multi", f"{fam} streams={1 + len(vals)}",
                    streams_of(TS.sort_tiles_multi(x, vals, tile_rows)),
                    streams_of(TS.sort_tiles_multi_plain(x, vals, tile_rows)))
        for run_log2 in (15, 18):
            rr = (1 << run_log2) // TS.LANES
            k1 = TS.sort_tiles_plain(x, rr)
            k2, v2 = TS.sort_tiles_kv_plain(x, iota, rr)
            k3, v3 = TS.sort_tiles_multi_plain(x, [iota, pay], rr)
            for streams in ([k1], [k2, v2], [k3, *v3]):
                compare("merge_pass_multi",
                        f"{fam} run=2^{run_log2} streams={len(streams)}",
                        streams_of(M.merge_pass_multi(
                            streams[0], streams[1:], 1 << run_log2)),
                        streams_of(M.merge_pass_multi_plain(
                            streams[0], streams[1:], 1 << run_log2)))
    # signed-val tiebreak of sort_tiles_kv: tied keys, vals across 2^31
    x = random_keys_bounded(n2, 0, 4, 3, dev)
    vals = random_keys(n2, 4, dev)
    compare("sort_tiles_kv", "signed tiebreak",
            streams_of(TS.sort_tiles_kv(x, vals, tile_rows)),
            streams_of(TS.sort_tiles_kv_plain(x, vals, tile_rows)))
    # compared payload with ties and a rider; a group of only 4 runs
    v0 = random_keys_bounded(n2, 0, 3, 5, dev)
    compare("sort_tiles_multi", "tied val0 + rider",
            streams_of(TS.sort_tiles_multi(x, [v0, vals], tile_rows)),
            streams_of(TS.sort_tiles_multi_plain(x, [v0, vals], tile_rows)))
    n4 = 4 << 15
    k4, v4 = TS.sort_tiles_multi_plain(x[:n4], [v0[:n4], vals[:n4]],
                                       tile_rows)
    compare("merge_pass_multi", "4-run group",
            streams_of(M.merge_pass_multi(k4, v4, 1 << 15)),
            streams_of(M.merge_pass_multi_plain(k4, v4, 1 << 15)))
    torch.cuda.synchronize()
    print(f"phase 2: kernels bit exact against plain versions "
          f"(6 key families, n=2^22, tile 2^15; "
          f"max_abs_err {max_err})")

    # ---- 3. main path end to end -------------------------------------------
    for counts in (TS.LAUNCHES, TS.PLAIN_CALLS, M.LAUNCHES, M.PLAIN_CALLS):
        for k in counts:
            counts[k] = 0
    n = 1 << 27
    keys = random_keys(n, 0, dev)
    want, want_perm = torch_sort_u32(keys)
    check_keys(merge_sort_keys(keys), want, "merge_sort_keys 2^27")
    short = keys[:n - 12345]
    check_keys(merge_sort_keys(short), torch_sort_u32(short)[0],
               "merge_sort_keys 2^27-12345")
    sk, sr = merge_sort_with_ranks(keys)
    check_ranks(keys, sk, sr, want, "merge_sort_with_ranks 2^27")
    del sk, sr, short

    step, (ek, ev) = entry(dev)
    ewant, eperm = torch_sort_u32(ek)
    sk, sv = step(ek, ev)
    check_keys(sk, ewant, "entry sort_kv keys")
    check_keys(sv, eperm.to(torch.int32).view(torch.uint32),
               "entry sort_kv positions")
    gen = torch.Generator(device=dev).manual_seed(6)
    fpay = torch.randn(ek.shape[0], generator=gen, device=dev)
    sk, sp = step(ek, fpay)
    check_keys(sp.view(torch.uint32), fpay[eperm].view(torch.uint32),
               "entry sort_kv f32 payload")
    ki = random_keys(1 << 20, 7, dev, dtype=torch.int32)
    check_keys(sort(ki, descending=True).view(torch.uint32),
               torch.sort(ki, descending=True).values.view(torch.uint32),
               "sort i32 descending")
    kf = torch.randn(1 << 20, generator=gen, device=dev)
    check_keys(sort(kf, descending=True).view(torch.uint32),
               torch.sort(kf, descending=True).values.view(torch.uint32),
               "sort f32 descending")
    torch.cuda.synchronize()
    print("phase 3: merge_sort_keys 2^27 and 2^27-12345, "
          "merge_sort_with_ranks 2^27 (stable), entry sort_kv 2^20 "
          "(u32, f32 payloads), sort i32/f32 descending: verified")

    # ---- 4. launch counters -----------------------------------------------
    launches = {**TS.LAUNCHES, **M.LAUNCHES}
    plain = {**TS.PLAIN_CALLS, **M.PLAIN_CALLS}
    print(f"phase 4: kernel launches {launches}; plain calls {plain}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")

    # ---- 5. kernels at the main path's shapes; times ---------------------
    def report(what, t, elems=n):
        print(f"time {what}: {t.ms:.3f} ms, {elems / t.seconds / 1e6:.1f} "
              f"Melem/s (n={elems}; {card})")

    t_keys = time_fn(merge_sort_keys, keys)
    report("merge_sort_keys", t_keys)
    t_kv = time_fn(merge_sort_with_ranks, keys)
    report("merge_sort_with_ranks", t_kv)
    report("torch.sort stable (values+indices)", time_fn(torch_sort_u32, keys))
    report("entry sort_kv 2^20", time_fn(step, ek, ev), ek.shape[0])

    # each kernel against its plain version at the main path's shapes: the
    # tile sort at n = 2^27, then every merge pass of the chain (run 2^15,
    # 2^18, 2^21, 2^24), each fed the kernel's previous output; checked bit
    # for bit, then both timed on the same inputs
    iota = iota_u32(n, dev)
    pay = random_keys(n, 2, dev)
    kernel_ms = {}

    def check_and_time(kname, what, fn, plain_fn, args):
        got = streams_of(fn(*args))
        compare(kname, f"{what} n=2^27", got, streams_of(plain_fn(*args)))
        tk = time_fn(fn, *args)
        tp = time_fn(plain_fn, *args)
        print(f"kernel {kname} [{what}] n={n}: bit exact; cuda {tk.ms:.3f} "
              f"ms, plain {tp.ms:.3f} ms ({card})")
        kernel_ms.setdefault(kname, (tk.ms, tp.ms))
        return got

    chains = [
        ("sort_tiles", "keys", TS.sort_tiles, TS.sort_tiles_plain,
         (keys, tile_rows)),
        ("sort_tiles_kv", "key+pos", TS.sort_tiles_kv,
         TS.sort_tiles_kv_plain, (keys, iota, tile_rows)),
        ("sort_tiles_multi", "key+pos+payload", TS.sort_tiles_multi,
         TS.sort_tiles_multi_plain, (keys, [iota, pay], tile_rows)),
    ]
    for kname, what, fn, plain_fn, args in chains:
        streams = check_and_time(kname, what, fn, plain_fn, args)
        run = 1 << 15
        while run < n:
            streams = check_and_time(
                "merge_pass_multi",
                f"{what} run=2^{run.bit_length() - 1}", M.merge_pass_multi,
                M.merge_pass_multi_plain, (streams[0], streams[1:], run))
            run *= M.KWAY
        del streams
    print(f"phase 5: every kernel bit exact against its plain version along "
          f"the main path at n=2^27 (max_abs_err {max_err})")

    sources = {
        "sort_tiles": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                       "lsdradixsort_tpu/kernels/tile_sort.py:337"),
        "sort_tiles_kv": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                          "lsdradixsort_tpu/kernels/tile_sort.py:238"),
        "sort_tiles_multi": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                             "lsdradixsort_tpu/kernels/tile_sort.py:298"),
        "merge_pass_multi": ("lsdradixsort_tpu_torch/csrc/merge.cu",
                             "lsdradixsort_tpu/kernels/merge.py:626"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1]}
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
