#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lsdradixsort_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: the card's name, its power limit (nvidia-smi), the build of
   the port's CUDA kernels from the sources in this checkout (with the
   registers and spills of each cluster_sort build, and the cluster size
   C and rows a thread E of each word count's 2^15-row tile, 1 to 4
   words), and the card's copy and read ceilings (core/roofline.py
   `measure_copy_gbps`, `measure_read_gbps`), the denominators of every
   bound below: a bound is the bytes a kernel must move over the copy
   ceiling, except the bytes it reads beyond those it writes (a
   histogram's keys, a compaction's mask), which go over the read
   ceiling.
2. Each kernel against its plain PyTorch version on the card, bit for
   bit, on uniform, all-equal, presorted, reversed, 97-distinct,
   {0, 0xFFFFFFFF} and "cluster boundary" keys (rows i, i + 2^13, i + 2^14
   and i + 3 * 2^13 of a tile tied: the pairs the cluster tile sort's
   cross-CTA stages compare) at n = 2^22: tile sorts with 1, 2 and 3
   streams at the 2^15-row tile; merge passes with 1, 2 and 3 streams at
   run_len 2^15 and 2^18, and a 4-run group, plus the signed-val tiebreak
   of sort_tiles_kv (also on the boundary keys); the tile sort and merge
   passes at ncmp = 3 (hi, lo, position), with and without a rider (the
   tile sort's 3 and 4 words); the merge design (tile_merge::cluster_sort:
   key, payload 0 and the index word) on every family with payload 0 of 3
   values, 1, 3, 16 and 17 riders, and on views 1-3 words off alignment;
   one cluster_sort launch a tile-sort call of 1..4 words at the 2^15-row
   tile, no bitonic_stage, and the design each call takes; keys alone
   at every family at tiles of 2^18 rows (launches as `tile_plan` says)
   and of the bench CLI's sweep, 2^11-2^16 rows; the kv and 3-word tile
   sorts at tiles of 2^18 rows, their stages above the cluster's span as
   bitonic_stage passes; merge_pass_runs and its range
   partition (merge_runs_splits) on every range of merge_runs_chunked
   (trimmed buffers) of each family cut into S = 8, 4, 2 sorted runs at
   nranges = 1, 2, 4, of the skewed layout of tests/test_bigsort.py:64-83
   and of runs no longer than one chunk (the JAX fallback's crash,
   ROADMAP Queue C 1), each merge also against a stable torch.sort; then
   on ranges seen through windows cut from their exact co-ranks
   (kernels/merge.py `window_table`): all-equal, few-unique and uniform
   keys, S = 2, 3, 8 runs of unequal lengths (one shorter than a tile),
   1, 2, 3 and 8 streams at ncmp 1-3, ranges that start mid-window and
   hold no whole number of tiles; digit histograms at (r, group) in
   (1,0), (2,5), (4,3), (4,0), (5,1), (8,0), (8,3), (9,1), (12,2) (each
   way of keeping the counters and its edges) and blocks 128, 512, 1024,
   2^13, 27648 and 2^17 (in parts), at blocks 512 and 2^13 also offset by
   one word, and digit_histogram; the device-memory histogram at r = 13
   and 16.
   The merge-path partition (merge_path_splits) and merge against their
   plain versions on all-equal, 97-distinct and uniform keys, with 1, 2,
   3 and 8 streams at every ncmp they allow, runs of 2^15, 1000 and 3
   rows and a last group of 5 runs, and a tail of all-ones rows;
   then the sampled partition's own edges: one key on 90 % of the rows,
   all-equal keys (a tie wider than a span), 3 distinct keys and globally
   presorted keys (boundaries on sample rows) at runs of 2^15 and 2^17
   (a last group of 5) and at run 2^21 of 2^24 rows (two coarse levels),
   ncmp 1-3; and for merge_runs_splits the hot key too, a run of 40 rows
   (shorter than a sample stride) and a range of over 1,024 tiles. The
   tile merge's own edges: runs on disjoint key ranges (every tile drawn
   from one window, the others of 0 rows) at 1-8 streams and ncmp 1-3,
   streams seen through views 1-3 words off 16-byte alignment (window
   starts at every residue mod 4, each compared stream at its own), tile
   counts below and no multiple of the persistent grid, and ranges of 8
   runs with 8 streams at ncmp 2 and 3. A short last tile and a short
   last run (the merge chain sorts n rows, nothing padded): every
   tile-sort design (keys, also at tiles of 2^11; kv by the position and
   by values across 2^31; two compared words; the merge design with 1 and
   17 riders, also on views 1-3 words off alignment; ncmp = 3 with and
   without a rider; tiles of 2^18 rows, whose short last tile sorts
   through a tile of scratch) at n = 2^15 k + r for k of 0, 1, 37 and r
   of 1, 2^13 +- 1, 2^14 + 3, 2^15 - 1, on tied, uniform, boundary-tied,
   all-equal and all-ones rows; the partition and merge on passes whose
   last group holds 1-8 runs, its last run of one row or a third of a
   run; the chain at n = 10^8, 1.8 * 10^8 and 2^27 + 1 (keys, kv, and
   key + payload 0 + a rider) against a stable torch.sort.
   Then the scans at 2^22, 100000 and 131712 words of full-range u32
   (wraparound) and of i32, block_prefix_sums at blocks 128, 512 and
   2^13; exclusive_scan at n = 0, 1, a scan tile and a CTA's words, each
   - 1, + 0 and + 1, and 2^27 + 13 (20 times), of uniform and of
   all-0xFFFFFFFF words; exclusive_scan_hierarchical at n = 1, 2, 3, 5, a
   block and a round of its grid plan each - 1, + 0 and + 1, two rounds
   and a ragged tail, and 2^27 + 13 (10 times), aligned and offset by one
   word; the scans of 8- and 16-bit dtypes; and
   transpose_tiled at (128, 256) and (16384, 256). Both kernels of the
   composed pass's row scans and transposes: block_scans at segments of
   1, 2, 3, 4, 16, 31, 32, 256, 257, 1024, 4096 and 8192 words, of one
   segment, 3, 517 and a ragged number of CTA spans, u32 and i32, each
   aligned and offset by one word, and the 8- and 16-bit dtypes;
   transpose_any at 1, 2, 3, 4, 5, 16, 17, 31, 32 and 33 columns and 4,
   36, 1003 and 16384 rows, u32 and i32, aligned and offset by one word;
   both on the path's (16384, 2^r) histograms. Then the run shuffles on
   the items their runs cover: fixed row runs of 8, 32,
   128 and 512 rows, reversed and permuted, a run count no multiple of
   runs_per_step, through the fixed path (run_rows overridden) and the
   variable path; variable runs of random lengths into permuted disjoint
   destinations; at 2^18 rows one run of 2^17 + 1000 rows, of which only
   the last 1000 are copied (the TPU's length cut), beside a run over
   the rows a whole copy would hit; word runs of random lengths at
   unaligned offsets with max_len_bits = 10; an x that is not 16-byte
   aligned, int32 and float32 rows and float32 words (moved as their
   bits). Then the query kernels: compaction of 1-4 streams and the
   fill-forward under masks of density 0, 0.01, 0.25 and 1 and one from
   each key family (a compaction only on its defined first count rows),
   compaction of 9 and 16 streams; the compaction's any-n entry at ragged
   n under each mask and at n = 1 - 4097, a mask and streams at 4-byte
   offsets (not 16-byte aligned), and ops/filter.py filter_kv at 2^22 +
   12345 rows against boolean indexing; the fill-forward at a ragged n, and
   probes (semi and not) of a 1024-key table in shared memory, a
   50,000-key table past it, and one with duplicate keys. Then
   the query entry points phase 3 does not run (bench/query.py
   entry_point_ops: NOT IN, the vmem fallbacks past a chain, lookups in
   every engine, 64-bit keys, MIN/MAX/COUNT, hash_join_multi's options,
   top_k's fast path), each against its plain reference, with the kernel
   calls that show the path it took; and the sort family's entry points
   against plain references at 2^22: sort64_with_ranks for u64, i64 and
   f64 keys, both directions, every strategy; sort_lex of 2, 3 and 7
   columns of mixed dtypes and directions; window_rank, each method. The
   gather of whole records at every element width (16, 8, 4 bytes, and
   bytes), rows one byte and one word off alignment, more and fewer
   output rows than input rows, and none.
   Then the distributed operator set of parallel/ on worlds of processes
   (entry.py `dryrun_multichip`, its six steps each verified): one rank
   on NCCL, and 4 ranks on this one card over gloo (NCCL refuses two
   ranks on one GPU; gloo stages the CUDA tensors' collectives through
   the host), untimed.
3. The main paths end to end. Merge: merge_sort_keys at 2^27 and
   2^27 - 12345 rows against torch.sort; merge_sort_with_ranks at 2^27
   with the stability check; the entry() step (sort_kv at 2^20) with u32
   and f32 payloads; sort of i32 and f32 keys, descending. Composed (the
   LSD radix pipeline): sort at 2^27, block 2^13, r = 1, 2, 4, 8 against
   torch.sort; sort_kv at 2^27, r = 8, with positions (stable); sort_kv
   with an f32 payload and sort of i32/f32 keys, descending, at 2^20;
   and the reference's flagship, 2^30 keys, r = 4, block 512, with its
   peak device memory. Chunked (a path of its own): sort_with_ranks_
   chunked and sort_kv_chunked (u32 payload) of the same 2^30 keys as 8
   segments of 2^27, chunk_log2 19, 2 ranges, each verified range by
   range (bench/flagship.py `RankedRanges`) with its phase times and peak
   memory. Records (a path of its own): sort_records of 10^8 gensort
   records of 100 bytes with 10-byte keys (portbench/data/
   gensort_records.py) against portbench/reference/sort_records.py, byte
   for byte, with its peak memory. 64-bit: sort64_with_ranks of 2^27 (hi, lo) planes, each
   strategy against a stable torch.sort of the int64 words (the "merge"
   strategy, the ncmp = 3 chain, a path of its own). Query (a path of its
   own): every op of bench/query.py at n = 10^8, nb = 10^7 (BASELINE
   configs 3 and 4), both engines where there are two, each checked
   against an independent plain reference, with its peak device memory
   and the kernel launches of one query; then window_rank of those 10^8
   rows (partition by the group keys, order by the filter keys), each
   method against a plain reference (a path of its own). The
   distributed path at D = 1 on NCCL, a world of one (bench/dist.py
   `dist_ops`, each op a path of its own): dist_sort and dist_sort_kv of
   the 2^27 keys (positions as the payload) against merge_sort_keys and
   merge_sort_with_ranks, dist_digit_histogram at r = 8, groups 0-3,
   against torch.bincount, and on the query data dist_filter_kv,
   dist_group_by_sum, dist_join, dist_join_multi, dist_top_k (k = 1024)
   and dist_unique against their single-chip ops, each on its defined
   part, then each timed beside its single-chip op (d1_dist_overhead =
   dist ms / single-chip ms: the machinery's cost on one card, not
   scaling). The benchmark CLI (a path of its own): `bench/runner.py`
   run_suite("all", 24, verify=True), every record of every suite
   (the dist suite on that world of one) verified against the numpy
   golden models.
4. Launch counters: every kernel launched on its path in phase 3 (each
   path's counts set to 0 just before it: the sort kernels during the
   sorts, merge_pass_runs with the segment sorts' kernels during the
   chunked sorts, the tile sort and merge pass during the 64-bit chain,
   the three query kernels during the queries, the fill-forward with
   the sort kernels during the window ranks, shuffle_row_runs with the
   sort, histogram, scan and query kernels during the bench runner; the
   merge-path partition wherever a merge pass runs;
   exclusive_scan_hierarchical only in the runner, whose scan/hier suite
   is its one caller), and no plain version ran; merge_pass_runs
   launched exactly once a range (2 a chunked sort), the hierarchical
   scan exactly 7 times in the runner; on every path one cluster_sort a
   tile-sort call (sort_tiles, sort_tiles_kv or sort_tiles_multi), no
   bitonic_stage, and each call counted once by its design
   (TS.DESIGN_CALLS); the query path's rider sorts on the merge design,
   merge_sort_keys on the network and a one-rider merge_sort_multi on the
   merge design. shuffle_elem_runs has
   no caller on any path, in either package: its launches are 0. Each
   dist op's path launched its kernels (the tile sorts and merge passes
   of its local sorts, the histogram, the compaction, the fill-forward,
   the scan of the many-to-many join) and no plain version; dist_sort and
   dist_sort_kv exactly 2 cluster_sort and 8 merge passes (two local
   merge sorts of 2^27 rows), dist_join exactly one fill-forward;
   sort_records of 10-byte keys exactly 3 cluster_sort (all 3 on the merge
   design), 12 merge passes (three sort_lex passes of 10^8 rows, the
   last run of each pass short) and one gather. Then one
   composed sort at each r = 1, 2, 4, 8 launches block_prefix_sums and
   transpose_tiled 32 / r times each, with no plain call.
5. Each kernel against its plain version at the main paths' shapes, bit
   for bit, then both timed (CUDA events, median of 5 after a warm-up),
   with one PyTorch call computing the same function beside them where
   there is one: the tile sorts at n = 2^27 (1, 2 and 3 streams), the
   merge design at the cells' shapes (2^28 rows with a rider, uniform and
   with Q1's ties; 2^27 rows with three riders), and
   every merge pass of the chain (run 2^15, 2^18, 2^21, 2^24), each fed
   the kernel's previous output, its partition (merge_path_splits) timed
   on its own beside it (the pass's time includes it) and traced, each
   of its launches' device time apart, the pass traced too for the tile
   merge's (merge_tiles) own device time beside its bound, the same
   chain of key, position and a payload at 10^8 rows (a short last tile,
   four passes with a short last run) beside 2^27, and the same at
   ncmp = 3 (hi, lo, position); merge_pass_runs on each range of the
   2^30 chunked pass (2 streams, untrimmed runs), its partition and its
   tile merge timed or traced on their own beside it, beside a stable
   torch.sort of the 2^30 int64 (key, position) words; the histogram of
   2^27 keys at each r, and of 2^27 all-equal keys at each r;
   exclusive_scan of each r's digit-major histogram (beside
   torch.cumsum) and of 2^27 words; block_prefix_sums of each r's
   histogram rows and transpose_tiled of each r's histogram, each timed
   in turns with its library call (torch.cumsum(dim=1),
   .t().contiguous()) and traced (bench/small_ops.py: event interval,
   host issue time, device time; the r = 8 records give the two entries
   of the kernels line `device_ms` and `library_device_ms`);
   exclusive_scan_hierarchical at 2^27 in turns with torch.cumsum (3
   turns of 5 events) and traced, beside exclusive_scan in turns with the
   same cumsum; block_prefix_sums at 2^27;
   transpose_tiled at (16384, 256) and (8192, 16384); the compaction of
   filter_kv (2 streams) and of the vmem hash_join (3 streams) at 10^8
   rows (beside torch.stack(streams, 1)[mask]; its bound counts each
   stream's 32-byte sectors that hold a selected row, all of which a
   kernel must read), the fill-forward of
   hash_join's 1.1 * 10^8 sorted rows, the probe of the vmem join's 1024-key table by 10^8 keys (and semi, beside
   torch.isin), and the 50,000-key table's probe; their bounds count the
   bytes the function needs from that run's data (a compaction's selected
   rows, the fill-forward's flagged rows); shuffle_row_runs on the
   runner's 2^20 rows in reversed fixed runs of 32, 128, 8 and 512 rows
   and the same through the variable path, each beside one index_copy_,
   and shuffle_elem_runs on 2^27 words in runs of random length below
   2^16 at unaligned offsets. Then the sorts:
   merge keys and kv, torch.sort, sort64_with_ranks at 2^27 with each
   strategy, the composed sort at each r and kv at r = 8 (2^27), and at
   2^30 the composed r = 4 sort beside merge_sort_keys, the scan and the
   r = 1 and r = 8 histograms beside the reference's RTX 3060 Ti numbers
   (BASELINE.md), and the flagship's r = 4, block 512 histogram, checked
   bit for bit against its plain version. Last the gather of whole
   records at sort_records' 10^8 rows of 100 bytes and at a ragged n of
   101-byte rows one byte off alignment, bit for bit against its plain
   version (one index_select), with its bound.

Each phase prints its seconds. The line before the last is a JSON object
with one entry per kernel; the last line is {"ok": true, "device":
{...}}. Without a CUDA device, or without the port's package beside it,
the script fails.
"""
from __future__ import annotations

import json
import re
import sys
import time


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1

    from lsdradixsort_tpu_torch.bench.flagship import (check_keys,
                                                       check_ranks,
                                                       chunked_record,
                                                       sort64_keys,
                                                       torch_sort_u32)
    from lsdradixsort_tpu_torch.core import keycodec, roofline
    from lsdradixsort_tpu_torch.core.convert import (i64_to_u32, iota_u32,
                                                     order_key, row_order,
                                                     sort_segments,
                                                     take_rows, u32_to_i64)
    from lsdradixsort_tpu_torch.core.datagen import (random_keys,
                                                     random_keys_bounded)
    from lsdradixsort_tpu_torch.core import timing
    from lsdradixsort_tpu_torch.core.timing import card_label
    from lsdradixsort_tpu_torch.entry import dryrun_multichip, entry
    from lsdradixsort_tpu_torch.bench import dist as BD
    from lsdradixsort_tpu_torch.bench.partition import trace_launches
    from lsdradixsort_tpu_torch.parallel import make_mesh
    from lsdradixsort_tpu_torch.bench import flagship as FL
    from lsdradixsort_tpu_torch.bench import query as Q
    from lsdradixsort_tpu_torch.bench import runner as RN
    from lsdradixsort_tpu_torch.bench import small_ops as SO
    from lsdradixsort_tpu_torch.kernels import _build
    from lsdradixsort_tpu_torch.kernels import aggregate as AG
    from lsdradixsort_tpu_torch.kernels import compaction as CP
    from lsdradixsort_tpu_torch.kernels import fill_forward as FF
    from lsdradixsort_tpu_torch.kernels import hash_table as HT
    from lsdradixsort_tpu_torch.kernels import histogram as H
    from lsdradixsort_tpu_torch.kernels import merge as M
    from lsdradixsort_tpu_torch.kernels import records as RC
    from lsdradixsort_tpu_torch.kernels import scan as SC
    from lsdradixsort_tpu_torch.kernels import shuffle as SH
    from lsdradixsort_tpu_torch.kernels import tile_sort as TS
    from lsdradixsort_tpu_torch.kernels import transpose as TR
    from lsdradixsort_tpu_torch.ops import bigsort as B
    from lsdradixsort_tpu_torch.ops.filter import filter_kv
    from lsdradixsort_tpu_torch.ops.sort import (_merge_chain, _sort_rows,
                                                 merge_sort_keys,
                                                 merge_sort_with_ranks, sort,
                                                 sort64_with_ranks, sort_kv,
                                                 sort_lex, sort_records)
    from portbench.data import gensort_records
    from portbench.reference import sort_records as records_ref
    from lsdradixsort_tpu_torch.ops.window import window_rank

    dev = torch.device("cuda")
    clock = [time.perf_counter()]

    def time_fn(fn, *args):
        """Median of 5 CUDA-event timings after a warm-up, as every time
        PERF.md records from this script (time_fn's default is 10)."""
        return timing.time_fn(fn, *args, iters=5)

    def phase_done(k):
        now = time.perf_counter()
        print(f"phase {k}: {now - clock[0]:.1f} s")
        clock[0] = now

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
    log = lib.with_suffix(".log").read_text().splitlines()
    for line in log:
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  {line.strip()}")
    # the cluster tile sort: registers and spills of each build, and the
    # plan of the paths' 2^15-row tile
    for i, line in enumerate(log):
        if "Compiling entry" in line and "cluster_sort" in line:
            tmpl = re.search(r"cluster_sortI(.*?)EEv", line).group(1)
            design = "tile_merge::" if "tile_merge" in line else ""
            props = [x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                     if "Used" in x or "spill" in x]
            print(f"{design}cluster_sort<{tmpl}>: {'; '.join(props)}")
    for w in (1, 2, 3, 4):
        p = TS.tile_plan(w, 15, 1 << 27)
        print(f"cluster_sort {w} words, 2^15-row tile: C={p.cluster} CTAs "
              f"of 2^{p.rows_log2} rows, E={1 << p.group_log2} rows a "
              f"thread, {p.threads} threads, {p.smem_bytes} B of shared "
              f"memory, {len(p.steps)} steps")
    print(f"tile_merge::cluster_sort (key, payload 0, index word) at the "
          f"2^{TS.MERGE_TILE_LOG2}-row tile: C={TS.MERGE_CLUSTER} CTAs of "
          f"2^{TS.MERGE_ROWS_LOG2} rows, E={1 << TS.MERGE_G} rows a thread, "
          f"{1 << (TS.MERGE_ROWS_LOG2 - TS.MERGE_G)} threads")
    ceiling = roofline.measure_copy_gbps(dev)
    roof = roofline.detect(dev)
    print(f"copy ceiling: {ceiling:.1f} GB/s (dst.copy_(src) of 1 GiB, read "
          f"+ write bytes, median of 5; spec {roof.spec_gbps:.0f} GB/s, "
          f"recorded {roof.hbm_gbps:.1f} GB/s; {card})")
    read_ceiling, read_rates = roofline.measure_read_gbps(dev)
    rates = ", ".join(f"{k} {v:.1f}" for k, v in read_rates.items())
    print(f"read ceiling: {read_ceiling:.1f} GB/s ({rates} GB/s; "
          f"2^27 int32 words read once, median of 5; {card})")

    def bound_ms(nbytes, reads=0):
        """Least ms to move nbytes, of which `reads` are read with no
        write to pair with (at the read ceiling; the rest, reads and
        writes together, at the copy ceiling)."""
        return ((nbytes - reads) / ceiling + reads / read_ceiling) / 1e6

    phase_done(1)

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
            # rows i, i + 2^13, i + 2^14 and i + 3 * 2^13 of each 2^15-row
            # tile share a key: the pairs of the cluster's cross-CTA stages
            "cluster_boundary": (random_keys_bounded(n // 4, 0, 5, seed, dev)
                                 .view(-1, 1, 1 << 13).expand(-1, 4, -1)
                                 .reshape(-1)),
        }

    max_err = {k: 0 for k in ("sort_tiles", "sort_tiles_kv",
                              "sort_tiles_multi", "merge_path_splits",
                              "merge_pass_multi",
                              "merge_pass_runs",
                              "block_digit_histograms", "exclusive_scan",
                              "exclusive_scan_hierarchical",
                              "block_prefix_sums", "transpose_tiled",
                              "compact_stream_multi", "fill_forward_last",
                              "probe_table", "shuffle_row_runs",
                              "shuffle_elem_runs", "filtered_run_sums",
                              "gather_records")}

    def compare(kernel, label, got, want):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            g, w = g.reshape(-1), w.reshape(-1)
            err = (int((u32_to_i64(g) - u32_to_i64(w)).abs().max())
                   if g.numel() else 0)
            max_err[kernel] = max(max_err[kernel], err)
            check_keys(g, w, f"{kernel} {label} stream {i}")

    # a wrapper's output as its list of streams, named at every call: one
    # tensor, a tuple or list of tensors, or a key and a list of values
    def one(t):
        return [t]

    def key_and_list(out):
        key, vals = out
        return [key, *vals]

    iota = iota_u32(n2, dev)
    pay = random_keys(n2, 2, dev)
    for fam, x in families(n2, 1).items():
        compare("sort_tiles", fam, one(TS.sort_tiles(x, tile_rows)),
                one(TS.sort_tiles_plain(x, tile_rows)))
        compare("sort_tiles_kv", fam,
                list(TS.sort_tiles_kv(x, iota, tile_rows)),
                list(TS.sort_tiles_kv_plain(x, iota, tile_rows)))
        for vals in ([pay], [iota, pay]):
            compare("sort_tiles_multi", f"{fam} streams={1 + len(vals)}",
                    key_and_list(TS.sort_tiles_multi(x, vals, tile_rows)),
                    key_and_list(TS.sort_tiles_multi_plain(x, vals,
                                                           tile_rows)))
        for run_log2 in (15, 18):
            rr = (1 << run_log2) // TS.LANES
            k1 = TS.sort_tiles_plain(x, rr)
            k2, v2 = TS.sort_tiles_kv_plain(x, iota, rr)
            k3, v3 = TS.sort_tiles_multi_plain(x, [iota, pay], rr)
            for streams in ([k1], [k2, v2], [k3, *v3]):
                compare("merge_pass_multi",
                        f"{fam} run=2^{run_log2} streams={len(streams)}",
                        key_and_list(M.merge_pass_multi(
                            streams[0], streams[1:], 1 << run_log2)),
                        key_and_list(M.merge_pass_multi_plain(
                            streams[0], streams[1:], 1 << run_log2)))
    # signed-val tiebreak of sort_tiles_kv: tied keys, vals across 2^31,
    # also tied across the cluster's CTAs
    vals = random_keys(n2, 4, dev)
    for what, x in (("signed tiebreak", random_keys_bounded(n2, 0, 4, 3, dev)),
                    ("signed tiebreak cluster_boundary",
                     families(n2, 3)["cluster_boundary"])):
        compare("sort_tiles_kv", what,
                list(TS.sort_tiles_kv(x, vals, tile_rows)),
                list(TS.sort_tiles_kv_plain(x, vals, tile_rows)))
    # compared payload with ties and a rider; a group of only 4 runs
    v0 = random_keys_bounded(n2, 0, 3, 5, dev)
    compare("sort_tiles_multi", "tied val0 + rider",
            key_and_list(TS.sort_tiles_multi(x, [v0, vals], tile_rows)),
            key_and_list(TS.sort_tiles_multi_plain(x, [v0, vals],
                                                   tile_rows)))
    # the merge design (tile_merge::cluster_sort: key, payload 0 and the
    # index word, at the 2^15-row tile): every family, payload 0 with ties
    # (Q1's 3 values), 1, 3, 16 and 17 riders (17: a second launch
    # carrying its one rider), and views 1-3 words off alignment
    riders = [random_keys(n2, 40 + i, dev) for i in range(17)]
    for fam, xf in families(n2, 9).items():
        for nr in (1, 3, 16, 17):
            before = dict(TS.DESIGN_CALLS)
            compare("sort_tiles_multi", f"{fam} tied val0 riders={nr}",
                    key_and_list(TS.sort_tiles_multi(xf, [v0, *riders[:nr]],
                                                     tile_rows)),
                    key_and_list(TS.sort_tiles_multi_plain(
                        xf, [v0, *riders[:nr]], tile_rows)))
            got = {k: v - before[k] for k, v in TS.DESIGN_CALLS.items()}
            if got != {"network": 0, "merge": 1}:
                raise AssertionError(f"merge design {fam} riders={nr}: "
                                     f"design calls {got}")
    xq = random_keys_bounded(n2 + 4, 0, 4, 41, dev)
    vq = random_keys_bounded(n2 + 4, 0, 3, 42, dev)
    rq = random_keys(n2 + 4, 43, dev)
    for nr in (1, 3):
        views = [xq[1:n2 + 1], [vq[3:n2 + 3]] + [rq[2:n2 + 2]] * nr]
        compare("sort_tiles_multi", f"views off alignment riders={nr}",
                key_and_list(TS.sort_tiles_multi(*views, tile_rows)),
                key_and_list(TS.sort_tiles_multi_plain(
                    views[0].contiguous(), [v.contiguous() for v in views[1]],
                    tile_rows)))
    del riders, xq, vq, rq
    print("phase 2: the merge design (key, payload 0, index word): every "
          "family, tied payload 0, 1/3/16/17 riders, views off alignment: "
          "bit exact, one merge-design call each")
    n4 = 4 << 15
    k4, v4 = TS.sort_tiles_multi_plain(x[:n4], [v0[:n4], vals[:n4]],
                                       tile_rows)
    compare("merge_pass_multi", "4-run group",
            key_and_list(M.merge_pass_multi(k4, v4, 1 << 15)),
            key_and_list(M.merge_pass_multi_plain(k4, v4, 1 << 15)))
    # ncmp = 3, the 64-bit chain's (hi, lo, position), with and without a
    # rider: the tile sort, then merge passes of plainly sorted tiles
    lo3 = random_keys_bounded(n2, 0, 3, 18, dev)
    for fam, x in families(n2, 1).items():
        for pays in ([lo3, iota], [lo3, iota, pay]):
            what = f"{fam} ncmp=3 streams={1 + len(pays)}"
            compare("sort_tiles_multi", what,
                    key_and_list(TS.sort_tiles_multi(x, pays, tile_rows,
                                                     ncmp=3)),
                    key_and_list(TS.sort_tiles_multi_plain(x, pays, tile_rows,
                                                           ncmp=3)))
            for run_log2 in (15, 18):
                k3, v3 = TS.sort_tiles_multi_plain(
                    x, pays, (1 << run_log2) // TS.LANES, ncmp=3)
                compare("merge_pass_multi", f"{what} run=2^{run_log2}",
                        key_and_list(M.merge_pass_multi(k3, v3, 1 << run_log2,
                                                        ncmp=3)),
                        key_and_list(M.merge_pass_multi_plain(
                            k3, v3, 1 << run_log2, ncmp=3)))
    # one cluster_sort launch a call of 1..4 words at the 2^15-row tile
    # (no bitonic_stage, no gather); then tiles of 2^18 rows, whose stages
    # above the cluster's span run as bitonic_stage passes between
    # cluster_sort launches
    x = families(n2, 7)["cluster_boundary"]
    calls = {
        "sort_tiles": (lambda: one(TS.sort_tiles(x, tile_rows)), 1,
                       "network"),
        "sort_tiles_kv": (lambda: list(TS.sort_tiles_kv(x, vals,
                                                        tile_rows)), 2,
                          "network"),
        "sort_tiles_multi key+pos+payload": (lambda: key_and_list(
            TS.sort_tiles_multi(x, [iota, pay], tile_rows)), 3, "merge"),
        "sort_tiles_multi ncmp=3": (lambda: key_and_list(
            TS.sort_tiles_multi(x, [lo3, iota], tile_rows, ncmp=3)), 3,
            "network"),
        "sort_tiles_multi ncmp=3 + rider": (lambda: key_and_list(
            TS.sort_tiles_multi(x, [lo3, iota, pay], tile_rows, ncmp=3)), 4,
            "network"),
    }
    for what, (call, words, design) in calls.items():
        before = dict(TS.KERNEL_LAUNCHES)
        before_d = dict(TS.DESIGN_CALLS)
        call()
        got = {k: v - before[k] for k, v in TS.KERNEL_LAUNCHES.items()}
        got_d = {k: v - before_d[k] for k, v in TS.DESIGN_CALLS.items()}
        want_l = {"bitonic_stage": 0, "cluster_sort": 1}
        want_d = {k: int(k == design) for k in TS.DESIGN_CALLS}
        print(f"phase 2: {what} ({words} words) at the 2^15-row tile: "
              f"kernel launches {got}, design calls {got_d}")
        if got != want_l or got_d != want_d:
            raise AssertionError(f"{what}: launches {got}, design calls "
                                 f"{got_d}, not {want_l}, {want_d}")
    big_rows = (1 << 18) // TS.LANES
    for fam, x in families(n2, 8).items():
        # keys alone at every family: the tile of 2^18 rows (C = 4 CTAs of
        # 2^15, its stage of distance 2^17 a device-memory pass) and the
        # bench CLI's sweep tiles of 2^11..2^16 rows (several tiles a CTA
        # below 2^15, C = 2 at 2^16)
        for t in (18, 11, 12, 13, 14, 16):
            before = dict(TS.KERNEL_LAUNCHES)
            compare("sort_tiles", f"{fam} tile=2^{t}",
                    one(TS.sort_tiles(x, (1 << t) // TS.LANES)),
                    one(TS.sort_tiles_plain(x, (1 << t) // TS.LANES)))
            got = {k: v - before[k] for k, v in TS.KERNEL_LAUNCHES.items()}
            if got != TS.tile_plan(1, t, n2).launches():
                raise AssertionError(f"sort_tiles tile 2^{t}: launches "
                                     f"{got}")
        if fam not in ("uniform", "distinct97", "cluster_boundary"):
            continue
        before = dict(TS.KERNEL_LAUNCHES)
        compare("sort_tiles_kv", f"{fam} tile=2^18",
                list(TS.sort_tiles_kv(x, vals, big_rows)),
                list(TS.sort_tiles_kv_plain(x, vals, big_rows)))
        compare("sort_tiles_multi", f"{fam} tile=2^18 streams=3",
                key_and_list(TS.sort_tiles_multi(x, [iota, pay], big_rows)),
                key_and_list(TS.sort_tiles_multi_plain(x, [iota, pay],
                                                       big_rows)))
        got = {k: v - before[k] for k, v in TS.KERNEL_LAUNCHES.items()}
        want_l = {k: sum(TS.tile_plan(w, 18, n2).launches()[k]
                         for w in (2, 3)) for k in got}
        if got != want_l:
            raise AssertionError(f"tile 2^18: launches {got}, not {want_l}")
    print(f"phase 2: keys alone at tiles of 2^11-2^16 and 2^18 rows, every "
          f"family, and tiles of 2^18 rows of 2 and 3 words: bit exact; "
          f"kernel launches {got} a family at 2 and 3 words (the stages "
          f"above the cluster's span as bitonic_stage passes)")
    del lo3
    # the merge-path merge's edges: all-equal keys, few uniques and
    # uniform keys; 1, 2, 3 and 8 streams at every ncmp they allow; runs of
    # a tile multiple, of 1000 rows (below a tile) and of 3 rows, with a
    # last group of 5 runs; a tail of all-ones rows (the largest words,
    # ties across every run). The CUDA partition against its plain version
    # on each, then the pass.
    def merge_case(label, streams, run, ncmp):
        perm = row_order(streams[:ncmp], run)
        streams = [take_rows(t, perm) for t in streams]
        k, vs = streams[0], streams[1:]
        compare("merge_path_splits", label,
                [M.merge_path_splits(k, vs, run, ncmp).view(torch.uint32)],
                [M.merge_path_splits_plain(k, vs, run, ncmp)
                 .view(torch.uint32)])
        compare("merge_pass_multi", label,
                key_and_list(M.merge_pass_multi(k, vs, run, ncmp)),
                key_and_list(M.merge_pass_multi_plain(k, vs, run, ncmp)))

    fams = families(n2, 36)
    extra = [iota, pay, random_keys_bounded(n2, 0, 5, 37, dev)] + [
        random_keys(n2, 38 + i, dev) for i in range(4)]
    for fam in ("all_equal", "distinct97", "uniform"):
        for run in (1 << 15, 1000, 3):
            m = (8 * 3 + 5) * run if run < 1 << 15 else 13 * run
            for ns, ncmp in ((1, 1), (2, 1), (2, 2), (3, 1), (3, 2),
                             (3, 3), (8, 1), (8, 2), (8, 3)):
                merge_case(f"{fam} run={run} n={m} streams={ns} ncmp={ncmp}",
                           [fams[fam][:m]] + [e[:m] for e in extra[:ns - 1]],
                           run, ncmp)
    padded = [t.view(torch.int32).clone()
              for t in [random_keys(n2, 39, dev)] + extra[:2]]
    for t in padded:
        t[n2 - 300_000:] = -1
    padded = [t.view(torch.uint32) for t in padded]
    for ncmp in (1, 2, 3):
        merge_case(f"0xFFFFFFFF-padded tail ncmp={ncmp}",
                   padded[:max(2, ncmp)] + [pay], 1 << 15, ncmp)
    del fams, padded
    # the sampled partition's own edges: one key on 90 % of the rows and
    # all-equal keys (a tie wider than a whole span), 3 distinct keys,
    # globally presorted keys (every boundary on a sample row), at runs of
    # 2^15 and 2^17 rows (a short last group of 5 runs) and of 2^21 rows
    # at 2^24 (three levels), ncmp 1-3
    def edge_keys(fam, n, seed):
        if fam == "hot90":
            x = random_keys(n, seed, dev).view(torch.int32)
            hot = random_keys_bounded(n, 0, 10, seed + 1, dev) != 0
            return torch.where(hot, torch.full_like(x, -(1 << 31)),
                               x).view(torch.uint32)
        if fam == "few3":
            return random_keys_bounded(n, 0, 3, seed, dev)
        if fam == "presorted":
            return iota_u32(n, dev)
        return torch.full((n,), 0x5EEDBEEF, dtype=torch.int32,
                          device=dev).view(torch.uint32)
    for fam in ("hot90", "few3", "presorted", "all_equal"):
        x = edge_keys(fam, n2, 71)
        for run in (1 << 15, 1 << 17):
            m = (8 + 5) * run if run == 1 << 17 else n2
            for ns, ncmp in ((1, 1), (2, 2), (3, 3)):
                merge_case(f"{fam} run={run} n={m} streams={ns} ncmp={ncmp}",
                           [x[:m]] + [e[:m] for e in extra[:ns - 1]], run,
                           ncmp)
        del x
    n24 = 1 << 24
    deep = [random_keys(n24, 72 + i, dev) for i in range(2)]
    for fam in ("hot90", "few3", "all_equal", "uniform"):
        x = (random_keys(n24, 74, dev) if fam == "uniform"
             else edge_keys(fam, n24, 75))
        for ns, ncmp in ((1, 1), (2, 2), (3, 3)):
            merge_case(f"{fam} run=2^21 n=2^24 streams={ns} ncmp={ncmp}",
                       [x] + deep[:ns - 1], 1 << 21, ncmp)
        del x
    del deep
    # the tile merge's own edges (csrc/merge.cu merge_tiles): runs on
    # disjoint key ranges, so that every tile is drawn from one window and
    # the 7 others hold 0 rows; streams seen through views 1-3 words off
    # 16-byte alignment, so that the windows' bulk copies start at every
    # residue mod 4 and each compared stream at its own; tile counts below
    # the persistent grid (132 SMs times 2-4 CTAs) and no multiple of it;
    # ncmp 1-3 with riders
    gen = torch.Generator(device=dev).manual_seed(81)
    for run, nruns in ((1 << 13, 8 * 7 + 3), (4096, 1000), (1000, 8 + 3)):
        m = run * nruns
        # run r of the pass holds keys in [o(r) w, (o(r) + 1) w), o a
        # permutation, so a group's merged order takes its runs one by one
        width = (1 << 32) // nruns
        order = torch.randperm(nruns, generator=gen, device=dev)
        disjoint = i64_to_u32((order.view(-1, 1) * width + torch.randint(
            0, width, (nruns, run), generator=gen, device=dev)).view(-1))
        for ns, ncmp in ((1, 1), (2, 2), (4, 2), (8, 3)):
            merge_case(f"one-window tiles run={run} n={m} streams={ns} "
                       f"ncmp={ncmp}", [disjoint] + [e[:m] for e in
                                                    extra[:ns - 1]],
                       run, ncmp)
        del disjoint
    for shift in (1, 2, 3):
        views = []
        for i, t in enumerate([random_keys(n2, 83, dev)] + extra[:3]):
            pad = (shift + i) % 4
            buf = torch.empty(n2 + 4, dtype=torch.int32, device=dev)
            buf[pad:pad + n2] = t.view(torch.int32)
            views.append(buf[pad:pad + n2].view(torch.uint32))
        for ns, ncmp, run in ((1, 1, 1 << 15), (2, 2, 1 << 15), (4, 3, 1000),
                              (3, 1, 3)):
            m = n2 if run == 1 << 15 else (8 * 3 + 5) * run
            merge_case(f"views {shift}-{shift + ns - 1} words off run={run} "
                       f"n={m} streams={ns} ncmp={ncmp}",
                       [v[:m] for v in views[:ns]], run, ncmp)
        del views
    for tiles, run in ((3, 1536), (1007, 4096)):
        m = tiles * M.TILE
        merge_case(f"{tiles} tiles run={run} n={m} streams=2 ncmp=2",
                   [random_keys(m, 84, dev), extra[0][:m]], run, 2)
    del extra
    print(f"phase 2: merge-path partition and merge bit exact on the edge "
          f"cases (max_abs_err {max_err['merge_path_splits']}, "
          f"{max_err['merge_pass_multi']})")
    # a short last tile and a short last run (the chain sorts n rows, no
    # padding): every tile-sort design at n = 2^15 k + r, k of 0, 1 and 37
    # whole tiles, r of 1, 2^13 +- 1, 2^14 + 3 and 2^15 - 1 rows (a CTA of
    # the merge design's 4 and of the networks' 2 partly or wholly past
    # n), on ties, uniform, boundary-tied, all-equal and all-ones rows
    # (the missing rows' own words): keys alone (also at tiles of 2^11:
    # several a CTA), kv by the position and by vals across 2^31, two
    # compared words, the merge design with 1 and 17 riders, ncmp = 3 with
    # and without a rider; tiles of 2^18 rows (device-memory stages: the
    # short last tile through a tile of scratch); the merge design on
    # views 1-3 words off alignment
    ones = torch.full((n2,), -1, dtype=torch.int32, device=dev).view(
        torch.uint32)
    rfams = {f: x for f, x in families(n2, 61).items()
             if f in ("uniform", "distinct97", "cluster_boundary",
                      "all_equal")}
    rfams["all_ones"] = ones
    rid = [random_keys(n2, 62 + i, dev) for i in range(17)]
    v0r = random_keys_bounded(n2, 0, 3, 63, dev)
    kvv = random_keys(n2, 64, dev).view(torch.int32).clone()
    kvv[::5] = 0x7FFFFFFF          # the missing rows' value, flipped
    kvv = kvv.view(torch.uint32)
    small_rows = (1 << 11) // TS.LANES
    short_tiles = 0
    for k in (0, 1, 37):
        for r in (1, (1 << 13) - 1, (1 << 13) + 1, (1 << 14) + 3,
                  (1 << 15) - 1):
            m = (k << 15) + r
            for fam, xf in rfams.items():
                x_, io, p_ = xf[:m], iota[:m], pay[:m]
                v0_ = (ones if fam == "all_ones" else v0r)[:m]
                lab = f"{fam} n=2^15*{k}+{r}"
                compare("sort_tiles", lab, one(TS.sort_tiles(x_, tile_rows)),
                        one(TS.sort_tiles_plain(x_, tile_rows)))
                compare("sort_tiles", f"{lab} tile=2^11",
                        one(TS.sort_tiles(x_, small_rows)),
                        one(TS.sort_tiles_plain(x_, small_rows)))
                for vv in (io, kvv[:m]):
                    compare("sort_tiles_kv", lab,
                            list(TS.sort_tiles_kv(x_, vv, tile_rows)),
                            list(TS.sort_tiles_kv_plain(x_, vv, tile_rows)))
                compare("sort_tiles_multi", f"{lab} 2 words",
                        key_and_list(TS.sort_tiles_multi(x_, [v0_],
                                                         tile_rows)),
                        key_and_list(TS.sort_tiles_multi_plain(
                            x_, [v0_], tile_rows)))
                for nr in (1, 17):
                    vals_ = [v0_, *(t[:m] for t in rid[:nr])]
                    compare("sort_tiles_multi", f"{lab} riders={nr}",
                            key_and_list(TS.sort_tiles_multi(x_, vals_,
                                                             tile_rows)),
                            key_and_list(TS.sort_tiles_multi_plain(
                                x_, vals_, tile_rows)))
                for pays in ([v0_, io], [v0_, io, p_]):
                    compare("sort_tiles_multi",
                            f"{lab} ncmp=3 streams={1 + len(pays)}",
                            key_and_list(TS.sort_tiles_multi(
                                x_, pays, tile_rows, ncmp=3)),
                            key_and_list(TS.sort_tiles_multi_plain(
                                x_, pays, tile_rows, ncmp=3)))
                short_tiles += 1
            x_ = rfams["distinct97"][:m]
            for what, call, plain in (
                    ("keys", lambda: one(TS.sort_tiles(x_, big_rows)),
                     lambda: one(TS.sort_tiles_plain(x_, big_rows))),
                    ("kv", lambda: list(TS.sort_tiles_kv(x_, kvv[:m],
                                                         big_rows)),
                     lambda: list(TS.sort_tiles_kv_plain(x_, kvv[:m],
                                                         big_rows))),
                    ("rider", lambda: key_and_list(TS.sort_tiles_multi(
                        x_, [iota[:m], pay[:m]], big_rows)),
                     lambda: key_and_list(TS.sort_tiles_multi_plain(
                         x_, [iota[:m], pay[:m]], big_rows)))):
                compare({"keys": "sort_tiles", "kv": "sort_tiles_kv",
                         "rider": "sort_tiles_multi"}[what],
                        f"{what} tile=2^18 n=2^15*{k}+{r}", call(), plain())
            base = (k << 15) + r + 4
            xq = random_keys_bounded(base, 0, 4, 66, dev)
            vq = random_keys_bounded(base, 0, 3, 67, dev)
            rq = random_keys(base, 68, dev)
            for off in (1, 2, 3):
                views = [xq[off:off + m], [vq[3 - off:3 - off + m],
                                           rq[off:off + m]]]
                compare("sort_tiles_multi",
                        f"views {off} off n=2^15*{k}+{r}",
                        key_and_list(TS.sort_tiles_multi(*views, tile_rows)),
                        key_and_list(TS.sort_tiles_multi_plain(
                            views[0].contiguous(),
                            [v.contiguous() for v in views[1]], tile_rows)))
            del xq, vq, rq, views
    del rid, rfams, kvv
    print(f"phase 2: every tile-sort design on a short last tile "
          f"({short_tiles} n and families, tiles of 2^11, 2^15 and 2^18, "
          f"views off alignment): bit exact")
    # merge passes with a short last run: a last group of 1-8 runs after
    # 0 and 3 whole groups, its last run of one row or of a third of a
    # run, runs of 2^15 and 1000 rows, 1, 3 and 4 streams at ncmp 1-3
    cases = 0
    mfams = ("distinct97", "uniform", "all_ones")
    fams = {**families(n2, 70), "all_ones": ones}
    extra = [pay, iota, random_keys_bounded(n2, 0, 5, 69, dev)]
    for run in (1 << 15, 1000):
        for q in (0, 3):
            for g in range(1, 9):
                for last in (1, run // 3 + 1):
                    m = (8 * q + g - 1) * run + last
                    fam = mfams[cases % 3]
                    x_ = fams[fam][:m]
                    for ns, ncmp in ((1, 1), (3, 2), (4, 3)):
                        label = (f"{fam} run={run} n={m} (last run {last}) "
                                 f"streams={ns} ncmp={ncmp}")
                        streams = sort_segments(
                            [x_, *(e[:m] for e in extra[:ncmp - 1])],
                            [e[:m] for e in extra[ncmp - 1:ns - 1]], run)
                        kx, vx = streams[0], streams[1:]
                        compare("merge_path_splits", label,
                                [M.merge_path_splits(kx, vx, run, ncmp)
                                 .view(torch.uint32)],
                                [M.merge_path_splits_plain(kx, vx, run, ncmp)
                                 .view(torch.uint32)])
                        compare("merge_pass_multi", label,
                                key_and_list(M.merge_pass_multi(kx, vx, run,
                                                                ncmp)),
                                key_and_list(M.merge_pass_multi_plain(
                                    kx, vx, run, ncmp)))
                    cases += 1
    del extra, fams, ones
    print(f"phase 2: merge-path partition and merge bit exact on {cases} "
          f"passes with a short last run (a last group of 1-8 runs)")
    # the chain at the cells' n: Q1's and the join's ~1.8 * 10^8 rows, the
    # records' 10^8, and 2^27 + 1 (a last group of one one-row run):
    # keys, kv and (key, payload 0) with a rider against the stable
    # torch.sort of the "xla" engine
    for m in (10 ** 8, 180_000_000, (1 << 27) + 1):
        k_ = random_keys_bounded(m, 0, 1 << 20, 71, dev)
        check_keys(merge_sort_keys(k_), torch_sort_u32(k_)[0],
                   f"merge_sort_keys n={m}")
        want, wperm = torch_sort_u32(k_)
        sk, sr = merge_sort_with_ranks(k_)
        check_ranks(k_, sk, sr, want, f"merge_sort_with_ranks n={m}")
        del want, wperm, sk, sr
        v_ = random_keys_bounded(m, 0, 3, 72, dev)
        r_ = random_keys(m, 73, dev)
        got = _sort_rows(k_, [v_], [r_], "merge")
        exp = _sort_rows(k_, [v_], [r_], "xla")
        for g, w, what in zip((got[0], *got[1], *got[2]),
                              (exp[0], *exp[1], *exp[2]),
                              ("key", "payload 0", "rider")):
            check_keys(g, w, f"chain (key, payload 0) + rider n={m} {what}")
        del k_, v_, r_, got, exp
    torch.cuda.synchronize()
    print("phase 2: the chain at n = 10^8, 1.8 * 10^8 and 2^27 + 1 (keys, "
          "kv, key + payload 0 + rider) against stable torch.sort: bit exact")
    # merge_pass_runs: every range of merge_runs_chunked (trimmed buffers
    # after the first range) against the plain version, and each merge
    # against a stable torch.sort: each family as S sorted runs with the
    # global positions as val0, the skewed layout, runs of one chunk
    real_runs = M.merge_pass_runs
    runs_label = [""]

    def runs_checked(run_streams, tables, **kw):
        label = f"{runs_label[0]} chunk0={kw['chunk0']}"
        part = {k: kw[k] for k in ("chunk0", "nchunks", "chunk_elems", "blk")
                if k in kw}
        compare("merge_path_splits", f"range partition {label}",
                [M.merge_runs_splits(run_streams, tables, **part)
                 .view(torch.uint32)],
                [M.merge_runs_splits_plain(run_streams, tables, **part)
                 .view(torch.uint32)])
        got = real_runs(run_streams, tables, **kw)
        compare("merge_pass_runs", label, got,
                M.merge_pass_runs_plain(run_streams, tables, **kw))
        return got

    def chunked_case(label, x, S, nranges, chunk_log2, rider=None):
        L = x.shape[0] // S
        runs = [[], []] + ([[]] if rider is not None else [])
        for s in range(S):
            k, idx = torch_sort_u32(x[s * L:(s + 1) * L])
            runs[0].append(k)
            runs[1].append(i64_to_u32(idx + s * L))
            if rider is not None:
                runs[2].append(rider[s * L:(s + 1) * L].view(torch.int32)
                               [idx].view(torch.uint32))
        runs_label[0] = label
        outs = B.merge_runs_chunked(runs, chunk_log2=chunk_log2,
                                    nranges=nranges, consume_inputs=True)
        wk, widx = torch_sort_u32(x)
        want = [wk, i64_to_u32(widx)] + (
            [rider.view(torch.int32)[widx].view(torch.uint32)]
            if rider is not None else [])
        for i, (o, w) in enumerate(zip(outs, want, strict=True)):
            check_keys(torch.cat(o), w, f"merge_runs_chunked {label} "
                       f"stream {i}")

    M.merge_pass_runs = runs_checked
    try:
        for fam, x in families(n2, 1).items():
            for S in (8, 4, 2):
                for nranges in (1, 2, 4):
                    chunked_case(f"{fam} S={S} nranges={nranges}", x, S,
                                 nranges, 16)
        chunked_case("uniform S=8 nranges=2 rider", random_keys(n2, 19, dev),
                     8, 2, 16, rider=pay)
        skew = torch.cat([random_keys_bounded(n2 // 8, s << 28,
                                              (s << 28) + 1000, 20 + s, dev)
                          for s in range(8)])
        chunked_case("skewed S=8 nranges=2", skew, 8, 2, 16)
        # runs of exactly one chunk: shorter than chunk + 2 table blocks
        for nranges in (2, 4):
            chunked_case(f"skewed runs of one chunk nranges={nranges}", skew,
                         8, nranges, 19)
            chunked_case(f"uniform runs of one chunk nranges={nranges}",
                         random_keys(n2, 28, dev), 8, nranges, 19)
        del skew
    finally:
        M.merge_pass_runs = real_runs
    # one range through windows made from its exact co-ranks: all-equal,
    # few-unique and uniform compared words (ncmp 1-3) and 0-6 riders,
    # S = 2, 3 and 8 runs of unequal lengths (as the trims leave them),
    # ranges that start mid-window and hold no whole number of tiles,
    # runs shorter than a tile; partition and merge against their plain
    # versions
    # (and, for the sampled partition: one key on 90 % of the rows, a run
    # of 40 rows, shorter than a sample stride of the others, and a range
    # of over 1,024 tiles, which takes three levels)
    rgen = torch.Generator(device=dev).manual_seed(45)
    for fam, hi_ in (("all_equal", 1), ("few", 3), ("uniform", 1 << 32),
                     ("hot90", 0)):
        for S, ns, ncmp in ((2, 1, 1), (3, 3, 3), (8, 8, 2), (8, 3, 3),
                            (3, 8, 1), (8, 8, 3), (2, 2, 2), (8, 2, 2)):
            deep = (S, ns, ncmp) == (8, 2, 2)
            lens = [int(v) for v in torch.randint(
                3000 if S == 8 else 200_000, 300_000, (S,), generator=rgen,
                device=dev)]
            if S == 8:
                lens[3] = 1000            # a run shorter than a tile
            if deep:
                lens = [600_000 + 1000 * s_ for s_ in range(S)]
                lens[5] = 40
            streams = [[], [], []] + [[] for _ in range(ns - 3)]
            for s_, ln in enumerate(lens):
                cols = [random_keys_bounded(ln, 0, hi_, 46 + s_ * 9 + i, dev)
                        if 0 < hi_ < 1 << 32 else random_keys(
                            ln, 46 + s_ * 9 + i, dev)
                        for i in range(max(ns, 3))]
                if fam == "hot90":
                    cols[0] = edge_keys("hot90", ln, 46 + s_ * 9)
                perm = row_order(cols[:ncmp], ln)
                for i in range(ns):
                    streams[i].append(take_rows(cols[i], perm))
            streams = streams[:ns]
            total = sum(lens)
            for lo_frac, count in (((0.02, total),) if deep else (
                    (0.0, total), (0.3, 3 * M.TILE + 1000),
                    (0.61, 40 * M.TILE + 17))):
                lo_rank = int(lo_frac * total)
                count = min(count, total - lo_rank)
                kw = dict(chunk0=0, nchunks=1, chunk_elems=count,
                          blk=M.DEF_BLK, ncmp=ncmp)
                whole = M.window_table([0] * S, lens, lo_rank)
                cr = M.merge_runs_splits_plain(streams, whole, **kw)
                first = [max(int(c) - 300, 0) // M.LANES * M.LANES
                         for c in cr[0, :S]]
                end = [min(int(c) + 300, ln) for c, ln in zip(cr[-1, :S],
                                                              lens)]
                tab = M.window_table(first, end, lo_rank)
                what = (f"windows {fam} S={S} streams={ns} ncmp={ncmp} "
                        f"lo={lo_rank} count={count}")
                compare("merge_path_splits", f"range partition {what}",
                        [M.merge_runs_splits(streams, tab, **kw)
                         .view(torch.uint32)],
                        [M.merge_runs_splits_plain(streams, tab, **kw)
                         .view(torch.uint32)])
                compare("merge_pass_runs", what,
                        M.merge_pass_runs(streams, tab, buf_elems=M.DEF_BUF,
                                          **kw),
                        M.merge_pass_runs_plain(streams, tab,
                                                buf_elems=M.DEF_BUF, **kw))
            del streams
    print(f"phase 2: merge_pass_runs and its range partition bit exact on "
          f"every range of merge_runs_chunked and on windowed ranges "
          f"(max_abs_err {max_err['merge_pass_runs']}, "
          f"{max_err['merge_path_splits']})")
    # digit histograms, each family at every (r, group) and block (the
    # counters a column a lane at r <= 4, a copy a warp to r = 8, a copy
    # a CTA to r = 12; blocks above UNIT_KEYS in parts), the keys aligned
    # and offset by one word (no 16-byte loads)
    for fam, x in families(n2, 1).items():
        xi = x.view(torch.int32)
        xo = torch.cat([xi[:1], xi])[1:].view(torch.uint32)
        for r, group in ((1, 0), (2, 5), (4, 3), (4, 0), (5, 1), (8, 0),
                         (8, 3), (9, 1), (12, 2)):
            for blk in (128, 512, 1024, 1 << 13, 3 * 1024 * 9, 1 << 17):
                for what, xx in (("", x), (" offset 1 word", xo)):
                    if what and blk not in (512, 1 << 13):
                        continue
                    xx = xx[:n2 // blk * blk]
                    compare("block_digit_histograms",
                            f"{fam} r={r} group={group} block={blk}{what}",
                            [H.block_digit_histograms(xx, r, group, blk)],
                            [H.block_digit_histograms_plain(xx, r, group,
                                                            blk)])
        compare("block_digit_histograms", f"{fam} digit_histogram r=8 g=2",
                [H.digit_histogram(x, 8, 2)],
                [H.block_digit_histograms_plain(x, 8, 2, n2)])
    # r above the shared-memory counters: the device-memory kernel
    for fam, x in families(n2, 40).items():
        for r, group, blk in ((13, 0, 1 << 13), (13, 1, 1 << 17),
                              (16, 1, 1 << 17), (16, 0, n2)):
            compare("block_digit_histograms",
                    f"{fam} r={r} group={group} block={blk}",
                    [H.block_digit_histograms(x, r, group, blk)],
                    [H.block_digit_histograms_plain(x, r, group, blk)])
    # scans: full-range u32 (wraparound), ragged lengths, i32
    for n_s in (n2, 100_000, 131_072 + 640):
        for dt in (torch.uint32, torch.int32):
            xs = random_keys(n_s, 8, dev, dtype=dt)
            for kname, fn, plain_fn in (
                    ("exclusive_scan", SC.exclusive_scan,
                     SC.exclusive_scan_plain),
                    ("exclusive_scan_hierarchical",
                     SC.exclusive_scan_hierarchical,
                     SC.exclusive_scan_hierarchical_plain)):
                got = fn(xs)
                if got.dtype != dt:
                    raise AssertionError(f"{kname} returned {got.dtype}")
                compare(kname, f"n={n_s} {dt}", [got], [plain_fn(xs)])
    xs = random_keys(n2, 9, dev)
    for blk in (128, 512, 1 << 13):
        compare("block_prefix_sums", f"block={blk}",
                list(SC.block_prefix_sums(xs, blk)),
                list(SC.block_prefix_sums_plain(xs, blk)))
    # the single-pass scan at the tile's edges and past 2^27, of uniform
    # and all-0xFFFFFFFF words (every add wraps); the large case 20 times,
    # where a look-back race would show
    tile_s, cta_s = SC._tile(), SC._lookback()[0]
    for n_s in (0, 1, tile_s - 1, tile_s, tile_s + 1, cta_s - 1, cta_s,
                cta_s + 1, (1 << 27) + 13):
        for fill, xs in (("uniform", random_keys(n_s, 34, dev)),
                         ("all 0xFFFFFFFF", torch.full(
                             (n_s,), -1, dtype=torch.int32,
                             device=dev).view(torch.uint32))):
            want_s = SC.exclusive_scan_plain(xs)
            for rep in range(20 if n_s > 1 << 27 and fill == "uniform"
                             else 1):
                compare("exclusive_scan", f"n={n_s} {fill} rep {rep}",
                        [SC.exclusive_scan(xs)], [want_s])
    del xs, want_s
    # the hierarchical scan at its grid plan's edges: one word, a block and
    # a round of the full grid each side, 2 rounds and a ragged tail, and
    # past 2^27; uniform and all-0xFFFFFFFF words, x aligned and offset by
    # one word (4-byte copies); the large case 10 times, where a barrier
    # race would show
    hb, ctas = SC.HIER_BLOCK, SC.hierarchical_ctas(dev)
    rnd = hb * ctas
    for n_s in (1, 2, 3, 5, hb - 1, hb, hb + 1, rnd - 1, rnd, rnd + 1,
                2 * rnd + 4 * 1001 + 3, (1 << 27) + 13):
        for fill in ("uniform", "all 0xFFFFFFFF"):
            xs = (random_keys(n_s + 1, 47, dev) if fill == "uniform" else
                  torch.full((n_s + 1,), -1, dtype=torch.int32,
                             device=dev).view(torch.uint32))
            for label, x_ in (("aligned", xs[:n_s]), ("offset 1", xs[1:])):
                want_s = SC.exclusive_scan_hierarchical_plain(x_)
                reps = (10 if n_s > 1 << 27 and fill == "uniform"
                        and label == "aligned" else 1)
                for rep in range(reps):
                    compare("exclusive_scan_hierarchical",
                            f"n={n_s} {fill} {label} rep {rep}",
                            [SC.exclusive_scan_hierarchical(x_)], [want_s])
    del xs, x_, want_s
    print(f"phase 2: exclusive_scan_hierarchical ({ctas} CTAs of {hb} words "
          f"a round) at n = 1 .. 2^27+13 (10 runs at 2^27+13), aligned and "
          f"offset by 1, all-0xFFFFFFFF words: bit exact")
    # 8- and 16-bit integers, scanned as int32 and cast back (mod 2^k)
    for dt in (torch.uint8, torch.int8, torch.uint16, torch.int16):
        xs = random_keys(n2 + 777, 35, dev).view(torch.int32).to(dt)
        for kname, fn, plain_fn in (
                ("exclusive_scan", SC.exclusive_scan,
                 SC.exclusive_scan_plain),
                ("exclusive_scan_hierarchical",
                 SC.exclusive_scan_hierarchical,
                 SC.exclusive_scan_hierarchical_plain),
                ("block_prefix_sums",
                 lambda x: SC.block_prefix_sums(x[:n2], 512),
                 lambda x: SC.block_prefix_sums_plain(x[:n2], 512))):
            got, want_s = fn(xs), plain_fn(xs)
            got = list(got) if isinstance(got, tuple) else [got]
            want_s = list(want_s) if isinstance(want_s, tuple) else [want_s]
            if any(g.dtype != dt for g in got):
                raise AssertionError(f"{kname} {dt} returned "
                                     f"{[g.dtype for g in got]}")
            compare(kname, f"{dt} n={xs.shape[0]}",
                    [g.to(torch.int32).view(torch.uint32) for g in got],
                    [w.to(torch.int32).view(torch.uint32) for w in want_s])
    del xs
    print(f"phase 2: exclusive_scan at n = 0 .. 2^27+13 (20 runs at 2^27+13)"
          f", all-0xFFFFFFFF words and 8/16-bit dtypes: bit exact")
    for shape, tile, dt in (((128, 256), 128, torch.int32),
                            ((16384, 256), 256, torch.uint32),
                            ((16384, 256), 256, torch.int32)):
        a = random_keys(shape[0] * shape[1], 10, dev, dtype=dt).view(shape)
        compare("transpose_tiled", f"{shape} {dt}",
                [TR.transpose_tiled(a, tile)], [TR.transpose_plain(a)])
    # the composed pass's row scans and transposes, both kernels of each:
    # block_scans in registers for power-of-two segments up to 256 words
    # (a lane, lanes of a warp, a warp in 2 loads), the tile scan for the
    # rest, for the n % 4 tail of 1- and 2-word segments and for an x that
    # is not 16-byte aligned; one segment, a few and a ragged number of CTA
    # spans of each; transpose_any in registers for up to 32 columns, rows
    # a multiple of 4 and aligned pointers, the shared-memory tiles for the
    # rest; then the path's (16384, 2^r) histograms
    for seg in (1, 2, 3, 4, 16, 31, 32, 256, 257, 1024, 4096, 8192):
        for nseg in (1, 3, 517, n2 // seg + 3):
            ns = nseg * seg
            for dt in (torch.uint32, torch.int32):
                xs = random_keys(ns + 1, 41, dev, dtype=dt)
                for label, x_ in (("aligned", xs[:ns]), ("offset 1", xs[1:])):
                    got = SC.block_scans(x_, seg)
                    if any(g.dtype != dt for g in got):
                        raise AssertionError(f"block_scans {dt} returned "
                                             f"{[g.dtype for g in got]}")
                    compare("block_prefix_sums",
                            f"block_scans seg={seg} n={ns} {dt} {label}",
                            list(got), list(SC._block_scans_plain(x_, seg)))
    for dt in (torch.uint8, torch.int8, torch.uint16, torch.int16):
        for seg in (2, 16, 256, 8192):
            xs = random_keys(2 * n2 + 1, 42, dev).view(torch.int32).to(dt)
            for label, x_ in (("aligned", xs[:2 * n2]), ("offset 1", xs[1:])):
                got = SC.block_scans(x_, seg)
                if any(g.dtype != dt for g in got):
                    raise AssertionError(f"block_scans {dt} returned "
                                         f"{[g.dtype for g in got]}")
                compare("block_prefix_sums",
                        f"block_scans seg={seg} {dt} {label}",
                        [g.to(torch.int32).view(torch.uint32) for g in got],
                        [w.to(torch.int32).view(torch.uint32)
                         for w in SC._block_scans_plain(x_, seg)])
    for cols in (1, 2, 3, 4, 5, 16, 17, 31, 32, 33):
        for nrows in (4, 36, 1003, 16384):
            for dt in (torch.uint32, torch.int32):
                a = random_keys(nrows * cols + 1, 43, dev, dtype=dt)
                for label, a_ in (
                        ("aligned", a[:nrows * cols].view(nrows, cols)),
                        ("offset 1", a[1:].view(nrows, cols))):
                    compare("transpose_tiled",
                            f"transpose_any ({nrows}, {cols}) {dt} {label}",
                            [TR.transpose_any(a_)], [TR.transpose_plain(a_)])
    for r in (8, 4, 2, 1):
        hist = random_keys_bounded(16384 << r, 0, 1 << 14, 44 + r,
                                   dev).view(16384, 1 << r)
        compare("block_prefix_sums", f"histogram rows r={r}",
                list(SC.block_scans(hist.view(-1), 1 << r)),
                list(SC._block_scans_plain(hist.view(-1), 1 << r)))
        compare("transpose_tiled", f"histogram r={r}",
                [TR.transpose_any(hist)], [TR.transpose_plain(hist)])
    del xs, a, hist
    print("phase 2: block_scans at seg 1-8192 (registers and tiles), n of "
          "one segment to ragged CTA spans, aligned and offset by 1, "
          "u32/i32/8/16-bit; transpose_any at cols 1-33, rows 4-16384, "
          "aligned and offset by 1; the path's histograms: bit exact")
    # the run shuffles, on the items the runs cover (the rest is
    # unspecified): fixed row runs of 8-512 rows, reversed and permuted,
    # with a run count that is no multiple of runs_per_step (the fixed
    # path with run_rows 3, which fixed_rows overrides, and the variable
    # path); variable runs of random lengths into permuted disjoint
    # destinations; the length cut at 2^18 rows (mb = 16: a run of 2^17 +
    # 1000 rows copies only its last 1000, beside a run that covers the
    # rows a copy of the whole run would hit); word runs of random lengths
    # (some past max_len_bits = 10, so cut) at unaligned offsets
    sgen = torch.Generator(device=dev).manual_seed(31)

    def covered(dst, start, end, size):
        """Items [dst + start, dst + end) of disjoint runs, as a mask."""
        edge = torch.zeros(size + 1, dtype=torch.int64, device=dev)
        one_each = torch.ones(dst.shape[0], dtype=torch.int64, device=dev)
        edge.index_add_(0, (dst + start).long(), one_each)
        edge.index_add_(0, (dst + end).long(), -one_each)
        return edge.cumsum(0)[:size] > 0

    def shuffle_case(kname, label, fn, plain_fn, args, mask):
        got = fn(*args)
        compare(kname, label, [got.view(torch.int32)[mask]],
                [plain_fn(*args).view(torch.int32)[mask]])
        return got

    def packed(lens, gap_max):
        """Run starts packed in order, with random gaps below gap_max."""
        gaps = torch.randint(0, gap_max, lens.shape, generator=sgen,
                             device=dev)
        return torch.cumsum(lens + gaps, 0) - lens

    def permuted_starts(lens, gap_max):
        order = torch.randperm(lens.shape[0], generator=sgen, device=dev)
        starts = torch.empty_like(lens)
        starts[order] = packed(lens[order], gap_max)
        return starts

    rows2 = n2 // SH.LANES
    xr = random_keys(n2, 32, dev).view(rows2, SH.LANES)
    for run in (8, 32, 128, 512):
        nch = rows2 // run - 3
        src = torch.arange(nch, dtype=torch.int32, device=dev) * run
        mask = torch.arange(rows2, device=dev) < nch * run
        for order, slot in (
                ("reversed", torch.arange(nch - 1, -1, -1, device=dev)),
                ("permuted", torch.randperm(nch, generator=sgen,
                                            device=dev))):
            dst = (slot * run).to(torch.int32)
            got = shuffle_case(
                "shuffle_row_runs", f"{order} runs of {run} rows, fixed",
                lambda *a, f=run: SH.shuffle_row_runs(*a, fixed_rows=f),
                lambda *a, f=run: SH.shuffle_row_runs_plain(*a, fixed_rows=f),
                (xr, src, dst, torch.full_like(src, 3), rows2), mask)
            if order == "reversed":
                check_keys(got[:nch * run], xr.view(torch.int32)[:nch * run]
                           .view(nch, run, -1).flip(0).reshape(-1, SH.LANES),
                           f"shuffle_row_runs reversed runs of {run} rows")
            shuffle_case("shuffle_row_runs", f"{order} runs of {run} rows, "
                         f"variable", SH.shuffle_row_runs,
                         SH.shuffle_row_runs_plain,
                         (xr, src, dst, torch.full_like(src, run), rows2),
                         mask)
    lens = torch.randint(1, 160, (rows2 // 164,), generator=sgen, device=dev)
    src, dst = packed(lens, 1), permuted_starts(lens, 1) + 5
    shuffle_case("shuffle_row_runs", f"{lens.shape[0]} variable runs, "
                 f"permuted",
                 SH.shuffle_row_runs, SH.shuffle_row_runs_plain,
                 (xr, src.int(), dst.int(), lens.int(), rows2),
                 covered(dst, 0, lens, rows2))
    big_rows, cut = 1 << 18, 1 << 17
    xb = random_keys(big_rows * SH.LANES, 33, dev).view(big_rows, SH.LANES)
    src = torch.tensor([7, cut], device=dev)
    dst = torch.tensor([100_000, 100_000], device=dev)
    lens = torch.tensor([cut + 1000, cut - 1], device=dev)
    start = torch.tensor([cut, 0], device=dev)
    got = shuffle_case("shuffle_row_runs", "2^18 rows, a run of 2^17 + 1000",
                       SH.shuffle_row_runs, SH.shuffle_row_runs_plain,
                       (xb, src.int(), dst.int(), lens.int(), big_rows),
                       covered(dst, start, lens, big_rows))
    check_keys(got[100_000 + cut:100_000 + cut + 1000],
               xb[7 + cut:7 + cut + 1000], "shuffle_row_runs 2^17 + 1000 cut")
    del xb, got
    lens = torch.randint(0, 3000, (n2 // 2100,), generator=sgen, device=dev)
    src, dst = packed(lens, 7), permuted_starts(lens, 6)
    shuffle_case("shuffle_elem_runs", f"{lens.shape[0]} runs < 3000 words, "
                 f"unaligned, max_len_bits=10",
                 lambda *a: SH.shuffle_elem_runs(*a, max_len_bits=10),
                 lambda *a: SH.shuffle_elem_runs_plain(*a, max_len_bits=10),
                 (pay, src.int(), dst.int(), lens.int(), n2),
                 covered(dst, lens & ~2047, lens, n2))
    # an x that is not 16-byte aligned (copied first), and 4-byte dtypes
    # other than uint32 (moved as their bits; the output is uint32)
    base = random_keys(n2 + 1, 42, dev)
    nch = rows2 // 32
    src = torch.arange(nch, dtype=torch.int32, device=dev) * 32
    dst = src.flip(0)
    mask = torch.ones(rows2, dtype=torch.bool, device=dev)
    for label, xm in (("misaligned", base[1:].view(rows2, SH.LANES)),
                      ("int32", base[:n2].view(torch.int32)
                       .view(rows2, SH.LANES)),
                      ("float32", base[:n2].view(torch.float32)
                       .view(rows2, SH.LANES))):
        got = shuffle_case("shuffle_row_runs", f"{label} x, runs of 32 rows",
                           SH.shuffle_row_runs, SH.shuffle_row_runs_plain,
                           (xm, src, dst, torch.full_like(src, 32), rows2),
                           mask)
        if got.dtype != torch.uint32:
            raise AssertionError(f"shuffle_row_runs {label}: {got.dtype}")
    lens = torch.randint(0, 3000, (n2 // 2100,), generator=sgen, device=dev)
    src, dst = packed(lens, 7), permuted_starts(lens, 6)
    shuffle_case("shuffle_elem_runs", "float32 x, unaligned runs",
                 SH.shuffle_elem_runs, SH.shuffle_elem_runs_plain,
                 (base[1:].view(torch.float32), src.int(), dst.int(),
                  lens.int(), n2), covered(dst, 0, lens, n2))
    del base, mask
    print(f"phase 2: run shuffles bit exact on the covered items "
          f"(max_abs_err {max_err['shuffle_row_runs']}, "
          f"{max_err['shuffle_elem_runs']})")
    # the query kernels: compaction of 1-4 streams and fill-forward under
    # masks of every density and a mask from each key family (only the
    # first count rows of a compaction are defined); probes of a table in
    # shared memory (1024 keys), one past it (50,000 keys, 452 rows) and
    # one with duplicate keys, semi and not
    gen = torch.Generator(device=dev).manual_seed(13)
    masks = {f"p={p}": torch.rand(n2, generator=gen, device=dev) < p
             for p in (0.0, 0.01, 0.25, 1.0)}
    for fam, x in families(n2, 1).items():
        for mname, m in {**masks,
                         "key bit 0": (x.view(torch.int32) & 1) == 1}.items():
            cnt = int(m.sum())
            for streams in ([x], [x, iota], [x, iota, pay],
                            [x, iota, pay, vals]):
                compare("compact_stream_multi",
                        f"{fam} {mname} streams={len(streams)}",
                        [o[:cnt] for o in CP.compact_stream_multi(m, streams)],
                        [o[:cnt] for o in CP.compact_stream_multi_plain(
                            m, streams)])
            compare("fill_forward_last", f"{fam} {mname}",
                    list(FF.fill_forward_last(m, x, pay)),
                    list(FF.fill_forward_last_plain(m, x, pay)))
    # more than 8 streams: one count and scan, scatters in groups of 8
    many = [iota, pay, vals] + [random_keys(n2, 41 + i, dev)
                                for i in range(13)]
    for mname in ("p=0.25", "p=0.01"):
        for k in (9, 16):
            cnt = int(masks[mname].sum())
            compare("compact_stream_multi", f"{mname} streams={k}",
                    [o[:cnt] for o in CP.compact_stream_multi(masks[mname],
                                                              many[:k])],
                    [o[:cnt] for o in CP.compact_stream_multi_plain(
                        masks[mname], many[:k])])
    del many
    # the any-n entry (ops/filter.py compact's): ragged n under every mask
    # and short n; a mask and streams at 4-byte offsets, through it and
    # through the public wrapper; and filter_kv past a tile multiple
    ragged = n2 - 12345
    x, y = random_keys(n2, 1, dev), iota
    for mname, m in {**masks, "key bit 0": (x.view(torch.int32) & 1) == 1
                     }.items():
        for rows in (ragged, 1, 100, 2047, 4097):
            sel, streams = m[:rows], [x[:rows], y[:rows], pay[:rows]]
            count, outs = CP._compact_rows(sel, streams)
            cnt = int(sel.sum())
            if int(count) != cnt:
                raise AssertionError(f"_compact_rows {mname} n={rows}: "
                                     f"count {int(count)}, want {cnt}")
            compare("compact_stream_multi", f"any n {mname} n={rows}",
                    [o[:cnt] for o in outs],
                    [o[:cnt] for o in CP._plain(sel, streams)])
    m = masks["p=0.25"]
    for rows, shift in ((ragged, 4), (n2 - 2 * CP.TILE, 4), (ragged, 7)):
        sel = m[shift:shift + rows]
        streams = [x[1:1 + rows], y[3:3 + rows]]
        cnt = int(sel.sum())
        kernel = (CP._compact_rows(sel, streams)[1] if rows % CP.TILE
                  else CP.compact_stream_multi(sel, streams))
        compare("compact_stream_multi",
                f"mask at byte {shift}, streams at words 1 and 3, n={rows}",
                [o[:cnt] for o in kernel],
                [o[:cnt] for o in CP._plain(sel, streams)])
    fk = random_keys_bounded(n2 + 12345, 0, 1 << 20, 5, dev)
    fv = random_keys(n2 + 12345, 6, dev)
    got = filter_kv(fk, fv, 1 << 18, 1 << 19)
    fsel = ((fk.view(torch.int32) >= 1 << 18)
            & (fk.view(torch.int32) < 1 << 19))
    cnt = int(fsel.sum())
    if int(got[0]) != cnt:
        raise AssertionError(f"filter_kv n={n2 + 12345}: count "
                             f"{int(got[0])}, want {cnt}")
    compare("compact_stream_multi", f"filter_kv n={n2 + 12345}",
            [g[:cnt] for g in got[1:]],
            [fk.view(torch.int32)[fsel].view(torch.uint32),
             fv.view(torch.int32)[fsel].view(torch.uint32)])
    del x, y, fk, fv, fsel, got
    print(f"phase 2: compaction at any n (ragged, 1-4097), unaligned mask "
          f"and streams, filter_kv at n={n2 + 12345}: bit exact")
    compare("fill_forward_last", f"n={ragged}",
            list(FF.fill_forward_last(masks["p=0.01"][:ragged],
                                      pay[:ragged], iota[:ragged])),
            list(FF.fill_forward_last_plain(masks["p=0.01"][:ragged],
                                            pay[:ragged], iota[:ragged])))
    small_keys = i64_to_u32(torch.randperm(1 << 12, generator=gen,
                                           device=dev)[:1024])
    wide_keys = i64_to_u32(torch.randperm(1 << 22, generator=gen,
                                          device=dev)[:50_000])
    dup_keys = random_keys_bounded(1024, 0, 300, 14, dev)
    tables = {
        "1024 keys": (HT.build_table(small_keys, pay[:1024],
                                     HT.plan_rows(1024)),
                      random_keys_bounded(n2, 0, 1 << 12, 15, dev)),
        "50000 keys": (HT.build_table(wide_keys, pay[:50_000],
                                      HT.plan_rows(50_000)),
                       random_keys_bounded(n2, 0, 1 << 22, 16, dev)),
        "duplicate keys": (HT.build_table(dup_keys, pay[:1024], 64),
                           random_keys_bounded(n2, 0, 400, 17, dev)),
    }
    for tname, (table, probes) in tables.items():
        for semi in (False, True):
            compare("probe_table", f"{tname} semi={semi}",
                    list(HT.probe_table(*table[:3], probes, semi=semi)),
                    list(HT.probe_table_plain(*table[:3], probes,
                                              semi=semi)))
    for fam, x in families(n2, 1).items():
        compare("probe_table", f"{fam} probes of the 1024-key table",
                list(HT.probe_table(*tables["1024 keys"][0][:3], x)),
                list(HT.probe_table_plain(*tables["1024 keys"][0][:3], x)))
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    print(f"phase 2: 1024-key table rows {tables['1024 keys'][0][0].shape[0]}"
          f", 50000-key table rows {tables['50000 keys'][0][0].shape[0]}; "
          f"shared memory a block can opt into: {optin} bytes")
    del masks, tables
    torch.cuda.synchronize()
    print(f"phase 2: kernels bit exact against plain versions "
          f"(6 key families, n=2^22, tile 2^15; "
          f"max_abs_err {max_err})")
    # the query entry points and paths that phase 3 does not run, at
    # n = 2^22, each against its plain reference and, where the path is
    # the point, with the kernel calls it must make (bench/query.py
    # entry_point_ops)
    edata = Q.make_data(dev, n2, n2 >> 4)
    for op in Q.entry_point_ops(edata):
        Q.run_once(op, check=True)
        print(f"phase 2: {Q.label(op)} n={n2}: verified"
              + (f" (kernel calls {op.calls})" if op.calls else ""))
    del edata
    # the sort family's entry points against plain references at 2^22:
    # 64-bit keys (stable torch.sort of the int64 or float64 words), the
    # multi-column sort (stable torch.sorts, last column first) and the
    # window ranks (torch.sort, cummax, cumsum)
    gen = torch.Generator(device=dev).manual_seed(21)
    for dtype in ("uint64", "int64", "float64"):
        if dtype == "float64":
            # rounded normals (ties), +0.0 for -0.0 (torch.sort ties them)
            f = torch.randn(n2, generator=gen, device=dev,
                            dtype=torch.float64)
            bits = ((f * 4).round() / 4 + 0.0).view(torch.int64)
            hi = i64_to_u32((bits >> 32) & 0xFFFFFFFF)
            lo = i64_to_u32(bits & 0xFFFFFFFF)
            ref = bits.view(torch.float64)
        else:
            hi = torch.cat([
                random_keys_bounded(n2 // 2, 0, 5, 23, dev).view(torch.int32),
                random_keys(n2 // 2, 22, dev).view(torch.int32)
            ]).view(torch.uint32)
            lo = random_keys_bounded(n2, 0, 1000, 24, dev)
            ref = order_key([hi, lo]) if dtype == "uint64" else (
                hi.view(torch.int32).to(torch.int64) * (1 << 32)
                + u32_to_i64(lo))
        for desc in (False, True):
            idx = torch.sort(ref, descending=desc, stable=True).indices
            for strategy in ("merge", "merge2", "xla"):
                what = f"sort64_with_ranks {dtype} desc={desc} {strategy}"
                gh, gl, gp = sort64_with_ranks(hi, lo, dtype=dtype,
                                               descending=desc,
                                               strategy=strategy)
                check_keys(gh, hi.view(torch.int32)[idx], f"{what} hi")
                check_keys(gl, lo.view(torch.int32)[idx], f"{what} lo")
                check_keys(gp, i64_to_u32(idx), f"{what} positions")
    print(f"phase 2: sort64_with_ranks u64/i64/f64, ascending and "
          f"descending, merge/merge2/xla n={n2}: verified")

    def lex_plain(cols, desc):
        perm = torch.arange(cols[0].shape[0], device=dev)
        for c, d in reversed(list(zip(cols, desc))):
            code = u32_to_i64(keycodec.encode(c, d))
            perm = perm[torch.sort(code[perm], stable=True).indices]
        return perm

    lex_cols = [random_keys_bounded(n2, 0, 5, 25, dev),
                random_keys_bounded(n2, 0, 7, 26, dev).view(torch.int32) - 3,
                (random_keys_bounded(n2, 0, 9, 27, dev).view(torch.int32)
                 - 4).to(torch.float32)] * 3
    for k, desc in ((2, (False, True)), (3, (True, False, False)),
                    (7, (False, True, False, True, True, False, False))):
        cols = lex_cols[:k]
        got_cols, got_perm = sort_lex(cols, descending=desc)
        want = lex_plain(cols, desc)
        check_keys(got_perm, i64_to_u32(want), f"sort_lex {k} columns perm")
        for i, (g, c) in enumerate(zip(got_cols, cols, strict=True)):
            check_keys(g.view(torch.uint32), c.view(torch.int32)[want],
                       f"sort_lex {k} columns col {i}")
    print(f"phase 2: sort_lex 2, 3, 7 columns (u32/i32/f32, mixed "
          f"directions) n={n2}: verified")

    def window_plain(part, order, method, desc=False):
        perm = lex_plain([part, order], (False, desc))
        pc = u32_to_i64(keycodec.encode(part))[perm]
        oc = u32_to_i64(keycodec.encode(order, desc))[perm]
        pos = torch.arange(pc.shape[0], device=dev)
        new_p = torch.ones_like(pc, dtype=torch.bool)
        new_p[1:] = pc[1:] != pc[:-1]
        new_o = new_p.clone()
        new_o[1:] |= oc[1:] != oc[:-1]
        pstart = torch.where(new_p, pos, 0).cummax(0).values
        if method == "row_number":
            rank = pos - pstart
        elif method == "rank":
            rank = torch.where(new_o, pos, 0).cummax(0).values - pstart
        else:
            c = new_o.cumsum(0)
            rank = c - c[pstart]
        out = torch.empty_like(rank)
        out[perm] = rank + 1
        return i64_to_u32(out)

    wpart = random_keys_bounded(n2, 0, 1000, 29, dev)
    worder = (random_keys_bounded(n2, 0, 100, 30, dev).view(torch.int32)
              - 50).to(torch.float32)
    for method in ("row_number", "rank", "dense_rank"):
        for desc in (False, True):
            check_keys(window_rank(wpart, worder, method, desc),
                       window_plain(wpart, worder, method, desc),
                       f"window_rank {method} desc={desc}")
    print(f"phase 2: window_rank row_number/rank/dense_rank, both "
          f"directions, n={n2}: verified")
    del wpart, worder, lex_cols

    # the gather of whole records: every element width of the kernel (16,
    # 8 and 4 bytes where the rows and both bases allow, else bytes), rows
    # one byte and one word off alignment, more and fewer output rows than
    # input rows, none, against the plain version
    gen_r = torch.Generator(device=dev).manual_seed(31)
    for rows_in, rows_out, width, offset in (
            (n2, n2, 100, 0), (n2, n2, 100, 4), (n2 + 12345, n2, 101, 1),
            (100_000, 300_000, 16, 0), (300_000, 100_000, 8, 0),
            (70_000, 70_000, 12, 0), (70_000, 70_000, 16, 4),
            (5_000, 5_000, 1, 0), (1_000, 1_000, 3000, 0), (10, 0, 100, 0)):
        buf = torch.randint(0, 256, (rows_in * width + offset,),
                            dtype=torch.uint8, device=dev, generator=gen_r)
        rec = buf[offset:].view(rows_in, width)
        perm = torch.randint(0, rows_in, (rows_out,), device=dev,
                             generator=gen_r).to(torch.int32).view(
                                 torch.uint32)
        got = RC.gather_records(rec, perm)
        if not torch.equal(got, RC.gather_records_plain(rec, perm)):
            raise AssertionError(f"gather_records {rows_in} rows of {width} "
                                 f"bytes at offset {offset} -> {rows_out}")
        del buf, rec, perm, got
    print("phase 2: gather_records at every element width, unaligned rows, "
          "m != n and m = 0: verified")

    # the distributed operator set on worlds of processes, every step
    # verified: one rank on NCCL, and 4 ranks on this one card over gloo
    # (NCCL refuses two ranks on one GPU; gloo stages the collectives of
    # CUDA tensors through the host), the kernels built above
    t_dry = time.perf_counter()
    dryrun_multichip(1)
    dryrun_multichip(4, backend="gloo", device="cuda:0")
    print(f"phase 2: dryrun_multichip(1) on NCCL and dryrun_multichip(4) "
          f"over gloo on cuda:0: every step verified, in "
          f"{time.perf_counter() - t_dry:.1f} s")
    phase_done(2)

    # ---- 3. main paths end to end -----------------------------------------
    modules = (TS, M, H, SC, TR, CP, FF, HT, SH, AG, RC)

    def reset_counts():
        for mod in modules:
            for counts in (mod.LAUNCHES, mod.PLAIN_CALLS):
                for k in counts:
                    counts[k] = 0
        for counts in (TS.KERNEL_LAUNCHES, TS.DESIGN_CALLS):
            for k in counts:
                counts[k] = 0

    def read_counts():
        """Launches by wrapper, with the tile sorts' launches by kernel
        (bitonic_stage, cluster_sort) and their calls by design
        (design.network, design.merge), and plain calls."""
        return ({k: v for mod in modules for k, v in mod.LAUNCHES.items()}
                | TS.KERNEL_LAUNCHES
                | {f"design.{k}": v for k, v in TS.DESIGN_CALLS.items()},
                {k: v for mod in modules for k, v in mod.PLAIN_CALLS.items()})

    reset_counts()
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

    # the composed LSD radix pipeline
    for r in (1, 2, 4, 8):
        check_keys(sort(keys, strategy="composed", r=r), want,
                   f"composed sort 2^27 r={r}")
    sk, sr = sort_kv(keys, iota_u32(n, dev), strategy="composed", r=8)
    check_ranks(keys, sk, sr, want, "composed sort_kv 2^27 r=8")
    del sk, sr
    sk, sp = sort_kv(ek, fpay, strategy="composed")
    check_keys(sk, ewant, "composed sort_kv 2^20 keys")
    check_keys(sp.view(torch.uint32), fpay[eperm].view(torch.uint32),
               "composed sort_kv f32 payload")
    check_keys(sort(ki, strategy="composed", descending=True)
               .view(torch.uint32),
               torch.sort(ki, descending=True).values.view(torch.uint32),
               "composed sort i32 descending")
    check_keys(sort(kf, strategy="composed", descending=True)
               .view(torch.uint32),
               torch.sort(kf, descending=True).values.view(torch.uint32),
               "composed sort f32 descending")
    big = random_keys(1 << 30, 11, dev)
    big_want = torch_sort_u32(big)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    check_keys(sort(big, strategy="composed", r=4, block_size=512), big_want,
               "composed sort 2^30 r=4 block=512")
    del big_want
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3: composed sort 2^27 r=1,2,4,8 (block 2^13), sort_kv "
          f"2^27 r=8 (stable), sort_kv f32 payload 2^20, sort i32/f32 "
          f"descending 2^20, sort 2^30 r=4 block 512: verified; 2^30 peak "
          f"device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
          f"held before the sort)")
    sort_launches, sort_plain = read_counts()

    # the chunked path: the same 2^30 keys as 8 segments of 2^27, ranks
    # only and with a u32 payload, each verified range by range
    del keys, want, want_perm
    reset_counts()
    records = [chunked_record(big, None, card)]
    print(f"phase 3: {json.dumps(records[-1])}")
    big_vals = random_keys(1 << 30, 12, dev)
    records.append(chunked_record(big, big_vals, card))
    print(f"phase 3: {json.dumps(records[-1])}")
    del big_vals
    chunked_launches, chunked_plain = read_counts()

    # the 64-bit path: sort64_with_ranks of 2^27 (hi, lo) planes, the
    # "merge" strategy (the ncmp = 3 chain) counted on its own, every
    # strategy against a stable torch.sort of the int64 words
    hi64, lo64 = random_keys(n, 11, dev), random_keys(n, 12, dev)
    wh, wl, widx = sort64_keys(hi64, lo64)
    for strategy in ("merge", "merge2", "xla"):
        if strategy == "merge":
            reset_counts()
        gh, gl, gp = sort64_with_ranks(hi64, lo64, strategy=strategy)
        if strategy == "merge":
            torch.cuda.synchronize()
            sort64_launches, sort64_plain = read_counts()
        check_keys(gh, wh, f"sort64_with_ranks 2^27 {strategy} hi")
        check_keys(gl, wl, f"sort64_with_ranks 2^27 {strategy} lo")
        check_keys(gp, i64_to_u32(widx),
                   f"sort64_with_ranks 2^27 {strategy} positions")
        del gh, gl, gp
    del wh, wl, widx
    print("phase 3: sort64_with_ranks 2^27 merge (ncmp=3 chain), merge2, "
          "xla: verified")

    # the records path (a path of its own): sort_records of the Sort
    # Benchmark's 10^8 gensort records of 100 bytes (10-byte keys), as the
    # benchmark's sortbench.indy.10gb makes them, against its plain
    # reference, byte for byte, with its peak device memory
    del hi64, lo64
    rcfg = {"records": 10**8, "record_bytes": 100, "key_bytes": 10}
    recs = gensort_records.make(rcfg, {}, 2**31 + 77, dev)["records"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t_rec = time.perf_counter()
    got = sort_records(recs, 10)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t_rec
    records_launches, records_plain = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = records_ref.expect({"records": recs, "key_bytes": 10})
    diff = records_ref.compare(got, want)
    if any(diff.values()):
        raise AssertionError(f"sort_records 10^8 x 100 B: {diff}")
    del got, want, recs
    print(f"phase 3: sort_records 10^8 records of 100 bytes, 10-byte keys: "
          f"verified against portbench/reference/sort_records.py; first call "
          f"{t_rec * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before)")
    hi64, lo64 = random_keys(n, 11, dev), random_keys(n, 12, dev)
    keys = random_keys(n, 0, dev)

    # the query path: every op of bench/query.py at n = 10^8, nb = 10^7,
    # both engines where there are two, each checked against an
    # independent plain reference, with its peak device memory and the
    # kernel launches of one query
    qdata = Q.make_data(dev)
    reset_counts()
    for op in Q.query_ops(qdata):
        before = read_counts()[0]
        peak_q, held_q = Q.run_once(op, check=True)
        used = {k: v - before[k] for k, v in read_counts()[0].items()
                if v != before[k]}
        print(f"phase 3: {Q.label(op)} n={qdata['n']} nb={qdata['nb']}: "
              f"verified; peak device memory {peak_q:.2f} GiB "
              f"({held_q:.2f} GiB held before); launches {used}")
    query_launches, query_plain = read_counts()

    # window ranks of config 3's columns: partition by the group keys,
    # order by the filter keys, each method against the plain reference
    reset_counts()
    for method in ("row_number", "rank", "dense_rank"):
        got = window_rank(qdata["gkeys"], qdata["keys"], method)
        torch.cuda.synchronize()
        if method == "row_number":
            window_launches, window_plain_calls = read_counts()
        check_keys(got, window_plain(qdata["gkeys"], qdata["keys"], method),
                   f"window_rank {method} n={qdata['n']}")
        del got
    print(f"phase 3: window_rank row_number/rank/dense_rank n={qdata['n']} "
          f"(partition by group keys, order by filter keys): verified")

    # the distributed path at D = 1 on NCCL, a world of one that the
    # bench runner's dist suite below reuses: each dist op of parallel/ on
    # the 2^27 keys and the query data, its launches counted (a path of
    # its own each), held on its defined part against its single-chip op
    # on the same data, then both timed; the ratio is the dist machinery's
    # overhead on one card, not scaling
    mesh = make_mesh()
    dist_launches, dist_rows = {}, []
    for op in BD.dist_ops(mesh, keys, qdata):
        reset_counts()
        got = op.run()
        torch.cuda.synchronize()
        dist_launches[op.name] = read_counts()
        op.check(got, op.single())
        del got
        t_d, t_s = time_fn(op.run), time_fn(op.single)
        dist_rows.append({"op": op.name, "single": op.single_name,
                          "devices": mesh.size, "ms": t_d.ms,
                          "single_ms": t_s.ms,
                          "d1_dist_overhead": t_d.ms / t_s.ms})
        used = {k: v for k, v in dist_launches[op.name][0].items() if v}
        print(f"phase 3: {op.name} D={mesh.size}: verified against "
              f"{op.single_name}; {t_d.ms:.3f} ms, single-chip "
              f"{t_s.ms:.3f} ms, d1_dist_overhead "
              f"{t_d.ms / t_s.ms:.3f}; launches {used} ({card})")
    print(f"phase 3: dist {json.dumps(dist_rows)}")

    # the benchmark CLI (a path of its own): every suite of bench/runner.py
    # at n = 2^24 with --verify, against the numpy golden models
    reset_counts()
    t_cli = time.perf_counter()
    cli_records, cli_failed = RN.run_suite("all", 24, verify=True)
    torch.cuda.synchronize()
    runner_launches, runner_plain = read_counts()
    unverified = [r.line() for r in cli_records if r.verified is not True]
    if cli_failed or unverified:
        raise AssertionError(f"bench runner: failed suites {cli_failed}, "
                             f"unverified records {unverified}")
    cli_suites = sorted({r.suite.split("/")[0] for r in cli_records})
    if cli_suites != sorted(RN.SUITES):
        raise AssertionError(f"bench runner: records of {cli_suites} only")
    print(f"phase 3: bench runner all --n 24 --verify: {len(cli_records)} "
          f"records of {cli_suites}, every one verified, in "
          f"{time.perf_counter() - t_cli:.1f} s")
    phase_done(3)

    # ---- 4. launch counters -----------------------------------------------
    query_kernels = ("compact_stream_multi", "fill_forward_last",
                     "probe_table", "filtered_run_sums")
    shuffle_kernels = ("shuffle_row_runs", "shuffle_elem_runs")
    # exclusive_scan_hierarchical runs on the bench runner's scan/hier
    # only: exclusive_scan no longer hands it its tile totals
    # (bitonic_stage runs only for tiles above a cluster's span: no path;
    # gather_records on the records path alone)
    sort_kernels = tuple(k for k in sort_launches
                         if k not in query_kernels + shuffle_kernels
                         + ("merge_pass_runs", "exclusive_scan_hierarchical",
                            "bitonic_stage", "gather_records")
                         and not k.startswith("design."))
    merge_kernels = ("sort_tiles_multi", "merge_path_splits",
                     "merge_pass_multi")
    # each path, its counts, and the kernels it must have launched
    paths = {
        "sort": (sort_launches, sort_plain, sort_kernels),
        "chunked": (chunked_launches, chunked_plain,
                    merge_kernels + ("merge_pass_runs",)),
        "sort64 merge (ncmp=3)": (sort64_launches, sort64_plain,
                                  merge_kernels),
        "query": (query_launches, query_plain, query_kernels),
        "records": (records_launches, records_plain,
                    merge_kernels + ("gather_records",)),
        "window_rank": (window_launches, window_plain_calls,
                        merge_kernels + ("fill_forward_last",)),
        "bench runner": (runner_launches, runner_plain,
                         ("shuffle_row_runs", "sort_tiles", "sort_tiles_kv",
                          "merge_path_splits", "merge_pass_multi",
                          "block_digit_histograms",
                          "exclusive_scan", "exclusive_scan_hierarchical")
                         + query_kernels),
    }
    # each dist op's own path, the kernels it must launch
    dist_need = {
        "dist_sort": ("sort_tiles", "merge_pass_multi"),
        "dist_sort_kv": ("sort_tiles_multi", "merge_pass_multi"),
        "dist_digit_histogram": ("block_digit_histograms",),
        "dist_filter_kv": ("compact_stream_multi",),
        "dist_group_by_sum": ("compact_stream_multi",),
        "dist_join": merge_kernels + ("fill_forward_last",
                                      "compact_stream_multi"),
        "dist_join_multi": merge_kernels + ("fill_forward_last",
                                            "exclusive_scan"),
        "dist_top_k": ("block_digit_histograms",),
        "dist_unique": ("compact_stream_multi",),
    }
    for op_name, need in dist_need.items():
        paths[op_name] = (*dist_launches[op_name], need)
    for pname, (lc, pc, need) in paths.items():
        print(f"phase 4: {pname} path: kernel launches "
              f"{ {k: v for k, v in lc.items() if v} }; plain calls "
              f"{ {k: v for k, v in pc.items() if v} }")
        idle = [k for k in need if lc[k] == 0]
        if idle:
            raise AssertionError(f"{pname}: kernels never launched on the "
                                 f"path: {idle}")
        # the paths' tiles fit a cluster: one cluster_sort a call of 1..4
        # words, no bitonic_stage
        tiles = {"bitonic_stage": 0,
                 "cluster_sort": lc["sort_tiles"] + lc["sort_tiles_kv"]
                 + lc["sort_tiles_multi"]}
        if any(lc[k] != v for k, v in tiles.items()):
            raise AssertionError(f"{pname}: tile sort kernel launches "
                                 f"{ {k: lc[k] for k in tiles} }, not "
                                 f"{tiles}")
        # each tile-sort call counted once, by the design that sorted it
        if lc["design.network"] + lc["design.merge"] != tiles["cluster_sort"]:
            raise AssertionError(f"{pname}: design calls "
                                 f"{lc['design.network']} + "
                                 f"{lc['design.merge']}, not "
                                 f"{tiles['cluster_sort']} tile sorts")
        if any(pc.values()):
            raise AssertionError(f"{pname}: plain versions ran")
    # exact counts: merge_pass_runs once a range, NRANGES a chunked sort
    # (each chunked_record sorts twice: a warm-up and the measured run);
    # the runner's scan/hier record calls the hierarchical scan 7 times (a
    # warm-up, 5 timed, the verify)
    # sort_records of 10-byte keys: three sort_lex passes of 10^8 rows
    # (4 merge passes each, the last run of each short), one gather
    exact = {"chunked": ("merge_pass_runs", chunked_launches,
                         2 * 2 * FL.NRANGES),
             "records (cluster_sort)": ("cluster_sort", records_launches, 3),
             # each sort_lex pass sorts (word, word, index) with riders:
             # the merge design
             "records (merge design)": ("design.merge", records_launches,
                                        3),
             "records (network)": ("design.network", records_launches, 0),
             "records (merge passes)": ("merge_pass_multi", records_launches,
                                        12),
             "records (gather)": ("gather_records", records_launches, 1),
             "bench runner": ("exclusive_scan_hierarchical",
                              runner_launches, 7)}
    # at D = 1 a dist sort of 2^27 rows is two local merge sorts: two tile
    # sorts (one cluster_sort each) and 2 * ceil(log8(2^27 / 2^15)) = 8
    # merge passes; the join's fill-forward runs once
    run, passes = 1 << 15, 0
    while run < n:
        run, passes = run * M.KWAY, passes + 2
    for op_name in ("dist_sort", "dist_sort_kv"):
        lc = dist_launches[op_name][0]
        exact[f"{op_name} (cluster_sort)"] = ("cluster_sort", lc, 2)
        exact[f"{op_name} (merge passes)"] = ("merge_pass_multi", lc, passes)
    exact["dist_join"] = ("fill_forward_last",
                          dist_launches["dist_join"][0], 1)
    for pname, (k, lc, want_n) in exact.items():
        print(f"phase 4: {pname} path: {k} launched {lc[k]} times "
              f"(expected {want_n})")
        if lc[k] != want_n:
            raise AssertionError(f"{pname}: {k} launched {lc[k]} times, "
                                 f"not {want_n}")
    # the rider path (the merge join, Q1's sums) takes the merge design; the
    # keys path keeps the network
    if query_launches["design.merge"] == 0:
        raise AssertionError("query path: no tile sort took the merge design")
    xk = random_keys(1 << 22, 44, dev)
    for what, call, want_d in (
            ("merge_sort_keys (keys)", lambda: merge_sort_keys(xk),
             {"network": 1, "merge": 0}),
            ("merge_sort_multi (a rider)",
             lambda: _merge_chain([xk, iota_u32(1 << 22, dev)], [xk], 15),
             {"network": 0, "merge": 1})):
        reset_counts()
        call()
        print(f"phase 4: {what}: design calls {dict(TS.DESIGN_CALLS)}")
        if dict(TS.DESIGN_CALLS) != want_d:
            raise AssertionError(f"{what}: design calls "
                                 f"{dict(TS.DESIGN_CALLS)}, not {want_d}")
    del xk
    # one composed sort at each r: the row scans and the transpose launch
    # once a pass, 32 / r times a sort
    for r in (1, 2, 4, 8):
        reset_counts()
        sort(keys, strategy="composed", r=r)
        torch.cuda.synchronize()
        lc, pc = read_counts()
        print(f"phase 4: composed sort r={r}: kernel launches "
              f"{ {k: v for k, v in lc.items() if v} }; plain calls "
              f"{ {k: v for k, v in pc.items() if v} }")
        wrong = {k: lc[k] for k in ("block_prefix_sums", "transpose_tiled")
                 if lc[k] != 32 // r}
        if wrong or any(pc.values()):
            raise AssertionError(f"composed sort r={r}: launches {wrong}, "
                                 f"not {32 // r} a kernel, or plain calls")
    # each kernel's launches on its own path; shuffle_elem_runs has no
    # caller on any path, in either package
    launches = {k: query_launches[k] if k in query_kernels
                else chunked_launches[k] if k == "merge_pass_runs"
                else records_launches[k] if k == "gather_records"
                else runner_launches[k] if k in shuffle_kernels
                + ("exclusive_scan_hierarchical",)
                else sort_launches[k] for k in sort_launches}
    phase_done(4)

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
    t64 = {}
    for strategy in ("merge", "merge2", "xla"):
        t64[strategy] = time_fn(lambda s=strategy: sort64_with_ranks(
            hi64, lo64, strategy=s))
        report(f"sort64_with_ranks {strategy}", t64[strategy])
    print(f"time sort64_with_ranks merge / merge2: "
          f"{t64['merge'].ms / t64['merge2'].ms:.3f} ({card})")

    # each kernel against its plain version at the main path's shapes: the
    # tile sort at n = 2^27, then every merge pass of the chain (run 2^15,
    # 2^18, 2^21, 2^24), each fed the kernel's previous output; checked bit
    # for bit, then both timed on the same inputs. The first call of each
    # kernel fills its row of the kernels line: ms, plain ms, the bound
    # (bound_ms of its bytes) and the library call's ms.
    iota = iota_u32(n, dev)
    pay = random_keys(n, 2, dev)
    rows = {}
    timed = {}     # kernel -> [(cuda ms, plain ms)] of every timed call

    def check_and_time(kname, what, fn, plain_fn, args, nbytes, split,
                       library=None, elems=n, defined=None, reads=0):
        """split: the output as its list of streams (one, list or
        key_and_list); defined: compare only that many first rows of each
        output (a compaction's defined prefix); reads: the bytes of nbytes
        read beyond those written (bound_ms)."""
        got = split(fn(*args))
        compare(kname, f"{what} n={elems}", [g[:defined] for g in got],
                [w[:defined] for w in split(plain_fn(*args))])
        tk = time_fn(fn, *args)
        tp = time_fn(plain_fn, *args)
        tl = time_fn(library) if library is not None else None
        timed.setdefault(kname, []).append((tk.ms, tp.ms))
        lib = f", library {tl.ms:.3f} ms" if tl is not None else ""
        print(f"kernel {kname} [{what}] n={elems}: bit exact; cuda "
              f"{tk.ms:.3f} ms, plain {tp.ms:.3f} ms{lib}, bound "
              f"{bound_ms(nbytes, reads):.3f} ms ({nbytes} bytes, {reads} "
              f"of them at the read ceiling; {card})")
        rows.setdefault(kname, {
            "ms": tk.ms, "plain_ms": tp.ms,
            "bound_ms": bound_ms(nbytes, reads),
            "bound_by": "bytes",
            "library_ms": tl.ms if tl is not None else None,
            "shape": f"{what} n={elems}"})
        return got

    def trace_splits(what, fn, *args):
        """The partition's launches apart: the device ms of each launch of
        one traced call (bench/partition.py `trace_launches`)."""
        launches = trace_launches(lambda: fn(*args))
        names = [k.replace("(anonymous namespace)::", "")
                 .replace("void ", "").split("(")[0] for k, _ in launches]
        parts = ", ".join(f"{k} {ms:.4f}"
                          for k, (_, ms) in zip(names, launches))
        print(f"trace merge_path_splits [{what}]: {len(launches)} launches, "
              f"{sum(ms for _, ms in launches):.4f} ms device: {parts} "
              f"({card})")

    def trace_merge(what, nbytes, fn):
        """merge_tiles' own device time apart from its partition's, from
        one traced call (bench/partition.py `trace_launches`), beside its
        bound: every stream read and written once."""
        launches = trace_launches(fn)
        ms = sum(t for k, t in launches if "merge_tiles" in k)
        part = [t for k, t in launches if "splits" in k]
        print(f"trace merge_tiles [{what}]: {ms:.4f} ms device, bound "
              f"{bound_ms(nbytes):.4f} ms ({100 * bound_ms(nbytes) / ms:.1f} "
              f"% of the kernel's time); the partition {sum(part):.4f} ms "
              f"in {len(part)} launches ({card})")

    def flipped(x):
        return x.view(torch.int32) ^ -(1 << 31)

    def as_u32(table):
        return [table.view(torch.uint32)]

    def splits_bytes(run):
        """The partition's bound: its table written once (it reads only
        the rows its searches probe, O(log) a boundary)."""
        return 4 * M.KWAY * M.tile_plan(n, run)[1]

    tile = tile_rows * TS.LANES
    chains = [
        ("sort_tiles", "keys", TS.sort_tiles, TS.sort_tiles_plain,
         (keys, tile_rows),
         lambda: torch.sort(flipped(keys).view(-1, tile), dim=1)),
        ("sort_tiles_kv", "key+pos", TS.sort_tiles_kv,
         TS.sort_tiles_kv_plain, (keys, iota, tile_rows),
         lambda w=order_key([keys, iota], flip1=True).view(-1, tile):
         torch.sort(w, dim=1)),
        ("sort_tiles_multi", "key+pos+payload", TS.sort_tiles_multi,
         TS.sort_tiles_multi_plain, (keys, [iota, pay], tile_rows), None),
    ]
    for kname, what, fn, plain_fn, args, library in chains:
        nbytes = 2 * 4 * n * (len(args) - 1 if kname != "sort_tiles_multi"
                              else 3)
        streams = check_and_time(
            kname, what, fn, plain_fn, args, nbytes,
            {"sort_tiles": one, "sort_tiles_kv": list,
             "sort_tiles_multi": key_and_list}[kname], library)
        run = 1 << 15
        while run < n:
            # library: one torch.sort of each group, of the keys or of the
            # int64 (key, pos) words; none moves a third stream
            group = min(M.KWAY * run, n)
            library = None
            if len(streams) == 1:
                library = (lambda x0=streams[0], group=group: torch.sort(
                    flipped(x0).view(-1, group), dim=1))
            elif len(streams) == 2:
                library = (lambda w=order_key(streams).view(-1, group):
                           torch.sort(w, dim=1))
            check_and_time(
                "merge_path_splits", f"{what} run=2^{run.bit_length() - 1}",
                M.merge_path_splits, M.merge_path_splits_plain,
                (streams[0], streams[1:2], run), splits_bytes(run), as_u32)
            trace_splits(f"{what} run=2^{run.bit_length() - 1}",
                         M.merge_path_splits, streams[0], streams[1:2], run)
            trace_merge(f"{what} run=2^{run.bit_length() - 1}",
                        2 * 4 * n * len(streams),
                        lambda s=streams, r=run: M.merge_pass_multi(
                            s[0], s[1:], r))
            streams = check_and_time(
                "merge_pass_multi",
                f"{what} run=2^{run.bit_length() - 1}", M.merge_pass_multi,
                M.merge_pass_multi_plain, (streams[0], streams[1:], run),
                2 * 4 * n * len(streams), key_and_list, library)
            del library
            run *= M.KWAY
        del streams
    # the key+pos+payload chain at 10^8 rows (the records' n; the join's
    # and Q1's n are no power-of-two count of tiles either), beside 2^27:
    # the tile sort's short last tile (3052 whole tiles and 5888 rows),
    # then four passes, the last run of each short
    n8 = 10 ** 8
    streams = check_and_time(
        "sort_tiles_multi", "key+pos+payload, a short last tile",
        TS.sort_tiles_multi, TS.sort_tiles_multi_plain,
        (random_keys(n8, 54, dev), [iota_u32(n8, dev), random_keys(n8, 55,
                                                                   dev)],
         tile_rows), 2 * 4 * n8 * 3, key_and_list, elems=n8)
    run = 1 << 15
    while run < n8:
        what = f"key+pos+payload run=2^{run.bit_length() - 1}, a short run"
        trace_merge(f"{what} n={n8}", 2 * 4 * n8 * 3,
                    lambda s=streams, r=run: M.merge_pass_multi(s[0], s[1:],
                                                                r))
        streams = check_and_time(
            "merge_pass_multi", what, M.merge_pass_multi,
            M.merge_pass_multi_plain, (streams[0], streams[1:], run),
            2 * 4 * n8 * 3, key_and_list, elems=n8)
        run *= M.KWAY
    del streams
    # the merge design at the cells' shapes: the join's and Q1's 2^28 rows
    # with one rider (uniform keys; Q1's 4 keys and 3 payload values), the
    # records' 2^27 rows with three riders
    for what, lg, few, nr in (("uniform, a rider", 28, None, 1),
                              ("Q1 ties, a rider", 28, (4, 3), 1),
                              ("uniform, three riders", 27, None, 3)):
        nn = 1 << lg
        if few is None:
            k_, v_ = random_keys(nn, 50, dev), iota_u32(nn, dev)
        else:
            k_ = random_keys_bounded(nn, 0, few[0], 51, dev)
            v_ = random_keys_bounded(nn, 0, few[1], 52, dev)
        rs = [random_keys(nn, 53 + i, dev) for i in range(nr)]
        check_and_time("sort_tiles_multi", f"merge design, {what}",
                       TS.sort_tiles_multi, TS.sort_tiles_multi_plain,
                       (k_, [v_, *rs], tile_rows), 2 * 4 * nn * (2 + nr),
                       key_and_list, elems=nn)
        del k_, v_, rs
    # the 64-bit chain at n = 2^27: (hi, lo, position) compared, ncmp = 3
    streams = check_and_time(
        "sort_tiles_multi", "hi+lo+pos ncmp=3",
        lambda k, v, t: TS.sort_tiles_multi(k, v, t, ncmp=3),
        lambda k, v, t: TS.sort_tiles_multi_plain(k, v, t, ncmp=3),
        (hi64, [lo64, iota], tile_rows), 2 * 4 * n * 3, key_and_list)
    run = 1 << 15
    while run < n:
        check_and_time(
            "merge_path_splits",
            f"hi+lo+pos ncmp=3 run=2^{run.bit_length() - 1}",
            lambda k, v, r: M.merge_path_splits(k, v, r, ncmp=3),
            lambda k, v, r: M.merge_path_splits_plain(k, v, r, ncmp=3),
            (streams[0], streams[1:3], run), splits_bytes(run), as_u32)
        trace_splits(f"hi+lo+pos ncmp=3 run=2^{run.bit_length() - 1}",
                     M.merge_path_splits, streams[0], streams[1:3], run, 3)
        trace_merge(f"hi+lo+pos ncmp=3 run=2^{run.bit_length() - 1}",
                    2 * 4 * n * 3, lambda s=streams, r=run:
                    M.merge_pass_multi(s[0], s[1:], r, ncmp=3))
        streams = check_and_time(
            "merge_pass_multi",
            f"hi+lo+pos ncmp=3 run=2^{run.bit_length() - 1}",
            lambda k, v, r: M.merge_pass_multi(k, v, r, ncmp=3),
            lambda k, v, r: M.merge_pass_multi_plain(k, v, r, ncmp=3),
            (streams[0], streams[1:], run), 2 * 4 * n * 3, key_and_list)
        run *= M.KWAY
    del streams
    print(f"phase 5: every merge-path kernel bit exact against its plain "
          f"version along the main path at n=2^27 (max_abs_err {max_err})")

    # the composed path's kernels at its shapes (2^27 keys, block 2^13):
    # the row scans and the transpose checked bit for bit and their plain
    # versions timed, then each timed in turns with its library call and
    # traced (bench/small_ops.py `record`); the r = 8 records fill the two
    # rows of the kernels line, with the traced device times
    blk = 1 << 13
    nb = n // blk
    for r in (8, 4, 2, 1):
        bins = 1 << r
        hist = check_and_time(
            "block_digit_histograms", f"r={r} group=0 block=2^13",
            H.block_digit_histograms, H.block_digit_histograms_plain,
            (keys, r, 0, blk), 4 * n + 4 * nb * bins, one,
            reads=4 * n - 4 * nb * bins)[0]
        digit_major = TR.transpose_any(hist).view(-1)
        check_and_time(
            "exclusive_scan", f"digit-major histogram r={r}",
            SC.exclusive_scan, SC.exclusive_scan_plain, (digit_major,),
            8 * nb * bins, one,
            lambda x=digit_major: torch.cumsum(x.view(torch.int32), 0,
                                               dtype=torch.int32),
            elems=nb * bins)
        plain = {"block_prefix_sums": (
            lambda h=hist, b=bins: SC._block_scans_plain(h.view(-1), b), list),
            "transpose_tiled": (lambda h=hist: TR.transpose_plain(h), one)}
        for kname, what, kernel, library, nbytes in SO.hist_cases(hist):
            plain_fn, split = plain[kname]
            compare(kname, f"{what} n={nb * bins}", split(kernel()),
                    split(plain_fn()))
            tp = time_fn(plain_fn)
            rec = SO.record(kname, what, kernel, library, nbytes, ceiling,
                            card)
            print(f"kernel {kname} [{what}] n={nb * bins}: bit exact; cuda "
                  f"{rec['ms']:.4f} ms (turns {rec['ms_turns']}; host "
                  f"{rec['host_ms']:.4f}, device {rec['device_ms']:.4f}), "
                  f"plain {tp.ms:.3f} ms, library {rec['library_ms']:.4f} ms "
                  f"(turns {rec['library_ms_turns']}; host "
                  f"{rec['library_host_ms']:.4f}, device "
                  f"{rec['library_device_ms']:.4f}), bound "
                  f"{rec['bound_ms']:.4f} ms ({nbytes} bytes; {card})")
            timed.setdefault(kname, []).append((rec["ms"], tp.ms))
            if r == 8:
                rows[kname] = {
                    "ms": rec["ms"], "plain_ms": tp.ms,
                    "bound_ms": rec["bound_ms"], "bound_by": "bytes",
                    "library_ms": rec["library_ms"],
                    "device_ms": rec["device_ms"],
                    "library_device_ms": rec["library_device_ms"],
                    "shape": f"{what} n={nb * bins}"}
    # at the sizes the JAX bench suites and the reference use for them:
    # the hierarchical scan of 2^27 words checked, its plain version
    # timed, then timed in turns with torch.cumsum (3 turns of 5 events)
    # and traced (bench/small_ops.py `record`), beside the look-back scan
    # in turns with the same cumsum
    kname = "exclusive_scan_hierarchical"
    compare(kname, f"2^27 words n={n}", [SC.exclusive_scan_hierarchical(keys)],
            [SC.exclusive_scan_hierarchical_plain(keys)])
    tp = time_fn(SC.exclusive_scan_hierarchical_plain, keys)

    def cumsum27():
        return torch.cumsum(keys.view(torch.int32), 0, dtype=torch.int32)

    rec = SO.record(kname, "2^27 words",
                    lambda: SC.exclusive_scan_hierarchical(keys), cumsum27,
                    8 * n, ceiling, card)
    look = SO.in_turns(lambda: SC.exclusive_scan(keys), cumsum27)
    print(f"kernel {kname} [2^27 words] n={n}: bit exact; cuda "
          f"{rec['ms']:.4f} ms (turns {rec['ms_turns']}; device "
          f"{rec['device_ms']:.4f}, {rec['kernels']:.0f} kernels a call), "
          f"plain {tp.ms:.3f} ms, library {rec['library_ms']:.4f} ms (turns "
          f"{rec['library_ms_turns']}; device {rec['library_device_ms']:.4f}"
          f"), bound {rec['bound_ms']:.4f} ms ({8 * n} bytes; {card}); "
          f"exclusive_scan in turns {look['kernel']}, cumsum "
          f"{look['library']}")
    timed.setdefault(kname, []).append((rec["ms"], tp.ms))
    rows[kname] = {
        "ms": rec["ms"], "plain_ms": tp.ms, "bound_ms": rec["bound_ms"],
        "bound_by": "bytes", "library_ms": rec["library_ms"],
        "device_ms": rec["device_ms"],
        "library_device_ms": rec["library_device_ms"],
        "shape": f"2^27 words n={n}"}
    check_and_time("block_prefix_sums", "2^27 words, block 2^13",
                   SC.block_prefix_sums, SC.block_prefix_sums_plain,
                   (keys, 1 << 13), 8 * n + 4 * (n >> 13), list,
                   lambda: torch.cumsum(keys.view(torch.int32)
                                        .view(-1, 1 << 13), 1,
                                        dtype=torch.int32))
    # all-equal keys: every key of a block lands in one counter
    same = torch.full((n,), 0x5EEDBEEF, dtype=torch.int32,
                      device=dev).view(torch.uint32)
    for r in (8, 4, 2, 1):
        check_and_time(
            "block_digit_histograms", f"all-equal keys r={r} block=2^13",
            H.block_digit_histograms, H.block_digit_histograms_plain,
            (same, r, 0, blk), 4 * n + 4 * nb * (1 << r), one,
            reads=4 * n - 4 * nb * (1 << r))
    del same
    check_and_time("exclusive_scan", "2^27 words", SC.exclusive_scan,
                   SC.exclusive_scan_plain, (keys,), 8 * n, one,
                   lambda: torch.cumsum(keys.view(torch.int32), 0,
                                        dtype=torch.int32))
    for shape in ((16384, 256), (8192, 16384)):
        a = random_keys(shape[0] * shape[1], 12, dev).view(shape)
        check_and_time("transpose_tiled", f"{shape}", TR.transpose_tiled,
                       lambda x, t: TR.transpose_plain(x), (a, 256),
                       8 * a.numel(), one, lambda a=a: a.t().contiguous(),
                       elems=a.numel())
    del a
    print(f"phase 5: every composed-path kernel bit exact against its plain "
          f"version at n=2^27 (max_abs_err {max_err})")

    # the query kernels at the query path's shapes (n = 10^8, nb = 10^7):
    # filter_kv's compaction (2 streams; padded to a multiple of 2^15) and
    # the vmem join's (3 streams), the fill-forward of hash_join's sorted
    # build + probe rows, and the probe of the vmem join's 1024-key table
    # (and, semi, of filter_in_set's), with the library call beside each
    # where one exists (boolean indexing of one stream; isin for semi).
    # A bound counts the bytes the function needs from this run's data:
    # a compaction reads each mask byte and, of each stream, every 32-byte
    # sector that holds a selected row (device memory moves whole
    # sectors), and writes the selected rows; the fill-forward reads each
    # flag, key and val only at the flagged rows, and writes 12 bytes a
    # row
    qn, qnb = qdata["n"], qdata["nb"]
    npad = -(-qn // CP.TILE) * CP.TILE

    def padded(x):
        return torch.cat([x.view(torch.int32), x.new_zeros(
            npad - x.shape[0]).view(torch.int32)]).view(x.dtype)

    def compaction_bytes(sel, k):
        """(nbytes, reads) of a compaction of k aligned u32 streams: the
        mask, each stream's sectors that hold a selected row (8 rows a
        sector) read, its selected rows written."""
        cnt = int(sel.sum())
        sectors = k * int(sel.view(-1, 8).any(1).sum())
        return (sel.shape[0] + 32 * sectors + 4 * k * cnt,
                sel.shape[0] + 32 * sectors - 4 * k * cnt)

    qk = u32_to_i64(qdata["keys"])
    sel = padded((qk >= Q.LO) & (qk < Q.HI))
    del qk
    cnt = int(sel.sum())
    fstreams = [padded(qdata["keys"]), padded(qdata["vals"])]
    nbytes, reads = compaction_bytes(sel, 2)
    print(f"compaction bounds: sector-aware {bound_ms(nbytes, reads):.3f} "
          f"ms ({nbytes} bytes, {reads} read only); the selected rows "
          f"alone (the earlier yardstick) "
          f"{bound_ms(npad + 16 * cnt, npad):.3f} ms ({card})")
    check_and_time("compact_stream_multi", "filter_kv: 2 streams",
                   CP.compact_stream_multi, CP.compact_stream_multi_plain,
                   (sel, fstreams), nbytes, list,
                   lambda: torch.stack([f.view(torch.int32)
                                        for f in fstreams], 1)[sel],
                   npad, cnt, reads=reads)
    small = HT.build_table(qdata["bkeys_s"], qdata["bvals_s"],
                           HT.plan_rows(Q.SMALL_BUILD))
    probes = qdata["pkeys_s"]
    match, bval = check_and_time(
        "probe_table", f"hash_join vmem: {Q.SMALL_BUILD}-key table, "
        f"{small[0].shape[0]} rows", HT.probe_table, HT.probe_table_plain,
        (*small[:3], probes), 12 * qn + 4 * small[0].numel() * 2 + 512,
        list, elems=qn)
    in_set = HT.build_table(qdata["bkeys_s"], qdata["bkeys_s"],
                            HT.plan_rows(Q.SMALL_BUILD))
    check_and_time(
        "probe_table", f"filter_in_set: semi, {Q.SMALL_BUILD}-key set",
        lambda *a: HT.probe_table(*a, semi=True),
        lambda *a: HT.probe_table_plain(*a, semi=True),
        (*in_set[:3], probes), 12 * qn + 4 * in_set[0].numel() + 512,
        list, lambda: torch.isin(u32_to_i64(probes),
                           u32_to_i64(qdata["bkeys_s"])), elems=qn)
    jsel = padded(match.view(torch.int32) == 1)
    jcnt = int(jsel.sum())
    jstreams = [padded(probes), fstreams[1], padded(bval)]
    del match, bval
    nbytes, reads = compaction_bytes(jsel, 3)
    check_and_time("compact_stream_multi", "hash_join vmem: 3 streams",
                   CP.compact_stream_multi, CP.compact_stream_multi_plain,
                   (jsel, jstreams), nbytes, list,
                   lambda: torch.stack([j.view(torch.int32)
                                        for j in jstreams], 1)[jsel],
                   npad, jcnt, reads=reads)
    del sel, fstreams, jsel, jstreams
    jkeys = torch.cat([qdata["bkeys"], qdata["pkeys"]])
    jperm = torch.sort(u32_to_i64(jkeys), stable=True).indices
    jn = jkeys.shape[0]
    ff_args = (jperm < qnb, jkeys.view(torch.int32)[jperm].view(torch.uint32),
               torch.cat([qdata["bvals"], qdata["vals"]]).view(torch.int32)
               [jperm].view(torch.uint32))
    del jkeys, jperm
    flagged = int(ff_args[0].sum())
    check_and_time("fill_forward_last", "hash_join: sorted build + probe rows",
                   FF.fill_forward_last, FF.fill_forward_last_plain, ff_args,
                   jn + 8 * flagged + 12 * jn, list, elems=jn)
    del ff_args
    wide = HT.build_table(wide_keys, pay[:50_000], HT.plan_rows(50_000))
    wide_probes = random_keys_bounded(n2, 0, 1 << 22, 16, dev)
    tk_ = time_fn(HT.probe_table, *wide[:3], wide_probes)
    print(f"time probe_table 50000-key table ({wide[0].shape[0]} rows, past "
          f"shared memory), 2^22 probes: {tk_.ms:.3f} ms ({card})")
    del wide, wide_probes, qdata
    # filtered_group_by_sum's reduction after the sort at Q1's n (TPC-H
    # SF 30's lineitem, 4 groups, 98 % kept) with values that wrap, at a
    # ragged n with a run end every 16 rows on average, through views one
    # word off alignment, and with every row rejected (count 0). Its
    # bound: the three streams read once (at the read ceiling), each run
    # end's key and sum written
    def run_streams(n, groups, kept_share, seed, offset=0):
        g = random_keys_bounded(n + offset, 0, groups, seed, dev)
        keep = random_keys(n + offset, seed + 1, dev).view(torch.int32)
        keep = keep.to(torch.int64) & 0xFFFF < int(kept_share * 65536)
        g = torch.where(keep, u32_to_i64(g), 0xFFFFFFFF)
        packed = (~keep).to(torch.int64) << 31 | torch.arange(
            n + offset, device=dev)
        order = torch.sort((g - (1 << 31)) << 32 | packed).indices
        streams = [i64_to_u32(x[order])[offset:] for x in (g, packed)]
        del g, packed, keep
        return streams + [random_keys(n + offset, seed + 2, dev)[offset:]]

    q1n = 180_000_000
    for what, n_, groups, share, offset in (
            ("Q1: 4 groups, 98 % kept, values that wrap", q1n, 4, 0.98, 0),
            ("ragged: 2^23 groups, 1 word off alignment", (1 << 27) + 12345,
             1 << 23, 0.75, 1),
            ("every row rejected", (1 << 22) + 3, 4, 0.0, 0)):
        st = run_streams(n_, groups, share, len(what), offset)
        c = int(AG.filtered_run_sums(*st)[0])
        if c != int(AG.filtered_run_sums_plain(*st)[0]) or (
                share == 0 and c != 0):
            raise AssertionError(f"filtered_run_sums [{what}]: count {c}")
        check_and_time("filtered_run_sums", what, AG.filtered_run_sums,
                       AG.filtered_run_sums_plain, st, 12 * n_ + 8 * c,
                       lambda out, c=c: [out[0].reshape(1), out[1][:c],
                                         out[2][:c]],
                       elems=n_, reads=12 * n_ - 8 * c)
        ops = trace_launches(lambda: AG.filtered_run_sums(*st))
        ms = sum(t for k, t in ops if "filtered_runs" in k)
        copy_ms = (12 * n_ + 8 * c) / ceiling / 1e6
        traced = ", ".join(f"{k} {t:.4f}" for k, t in ops)
        print(f"trace filtered_runs [{what}]: {ms:.4f} ms device, bound "
              f"{bound_ms(12 * n_ + 8 * c, 12 * n_ - 8 * c):.4f} ms (all "
              f"bytes at the copy ceiling: {copy_ms:.4f} ms); device ops "
              f"traced: {traced} ({card})")
        del st
    print(f"phase 5: every query-path kernel bit exact against its plain "
          f"version at n={qn} (max_abs_err {max_err})")

    # the run shuffles at the runner's shape, n = 2^27 words (2^20 rows):
    # the suite's reversed fixed runs of 32 and 128 rows, then its sweep's
    # 8 and 512, then the same runs through the variable path; and word
    # runs of random lengths below 2^16 at unaligned offsets, packed into
    # a permuted order. Bound: every copied word read and written once.
    # Library: one index_copy_ of the runs as rows; the variable path's
    # runs have equal lengths here, so the same call computes its output
    rows5 = n // SH.LANES
    x5 = keys.view(rows5, SH.LANES)
    for fixed_path in (True, False):
        for run in (32, 128, 8, 512):
            nch = rows5 // run
            src = torch.arange(nch, dtype=torch.int32, device=dev) * run
            dst = src.flip(0)
            library = (lambda idx=(dst // run).long(), nch=nch,
                       o=torch.empty_like(x5.view(torch.int32)):
                       o.view(nch, -1).index_copy_(
                           0, idx, x5.view(torch.int32).view(nch, -1)))
            f = run if fixed_path else 0
            check_and_time(
                "shuffle_row_runs",
                f"{'fixed' if fixed_path else 'variable'} runs of {run} "
                f"rows, reversed",
                lambda *a, f=f: SH.shuffle_row_runs(*a, fixed_rows=f),
                lambda *a, f=f: SH.shuffle_row_runs_plain(*a, fixed_rows=f),
                (x5, src, dst, torch.full_like(src, run), rows5), 8 * n, one,
                library)
            del library
    lens = torch.randint(1, 1 << 16, (n >> 14,), generator=sgen, device=dev)
    lens = lens[:int((torch.cumsum(lens, 0) <= n).sum())]
    src, dst = packed(lens, 1), permuted_starts(lens, 1)
    words = int(lens.sum())
    check_and_time("shuffle_elem_runs",
                   f"{lens.shape[0]} runs of random length < 2^16, unaligned",
                   SH.shuffle_elem_runs, SH.shuffle_elem_runs_plain,
                   (keys, src.int(), dst.int(), lens.int(), n), 8 * words,
                   one, elems=words, defined=words)
    del x5, src, dst, lens
    print(f"phase 5: both run shuffles bit exact against their plain "
          f"versions at n=2^27 (max_abs_err {max_err['shuffle_row_runs']}, "
          f"{max_err['shuffle_elem_runs']})")

    # the sorts: composed at each r and kv, then the reference's 2^30
    for r in (1, 2, 4, 8):
        report(f"composed sort r={r} block 2^13",
               time_fn(sort, keys, "composed", r))
    report("composed sort_kv r=8 (positions)",
           time_fn(lambda k, v: sort_kv(k, v, strategy="composed", r=8),
                   keys, iota))
    del iota, pay
    n30 = 1 << 30
    report("composed sort 2^30 r=4 block 512 (reference: 2683.12 ms on an "
           "RTX 3060 Ti)",
           time_fn(lambda k: sort(k, strategy="composed", r=4,
                                  block_size=512), big), n30)
    report("merge_sort_keys 2^30", time_fn(merge_sort_keys, big), n30)
    report("exclusive_scan 2^30 (reference: 70.410 ms on an RTX 3060 Ti)",
           time_fn(SC.exclusive_scan, big), n30)
    report("histogram 2^30 r=1 block 128 (reference: 14.446 ms on an RTX "
           "3060 Ti)", time_fn(H.block_digit_histograms, big, 1, 0, 128),
           n30)
    report("histogram 2^30 r=8 block 512 (reference: 18.974 ms on an RTX "
           "3060 Ti)", time_fn(H.block_digit_histograms, big, 8, 0, 512),
           n30)
    check_and_time("block_digit_histograms", "the flagship's: r=4 block=512",
                   H.block_digit_histograms, H.block_digit_histograms_plain,
                   (big, 4, 0, 512), 4 * n30 + 4 * (n30 // 512) * 16, one,
                   elems=n30, reads=4 * n30 - 4 * (n30 // 512) * 16)
    # merge_pass_runs on each range of the 2^30 chunked pass: 2 streams,
    # the untrimmed runs of the 8 segment sorts; bound: every row of the
    # pass read and written once (2 streams x 4 bytes x 2 x 2^30), library:
    # one stable torch.sort of the 2^30 int64 (key, position) words
    seg = n30 // 8
    runs = [[], []]
    for s_ in range(8):
        k, (r,) = _merge_chain(
            [big[s_ * seg:(s_ + 1) * seg],
             i64_to_u32(torch.arange(s_ * seg, (s_ + 1) * seg, device=dev))],
            (), 15)
        runs[0].append(k)
        runs[1].append(r)
        del k, r
    nch = n30 >> 19
    tab = M.merge_tables_exact_runs(runs[0], 1 << 19)[0].cpu()
    for ri in range(2):
        part = dict(chunk0=ri * nch // 2, nchunks=nch // 2,
                    chunk_elems=1 << 19)
        kw = dict(part, buf_elems=M.DEF_BUF)
        # its partition alone (part of the range's time): the table
        # written once is its bound
        check_and_time(
            "merge_path_splits", f"2^30 pass, range {ri} of 2, partition",
            lambda rs, t, part=part: M.merge_runs_splits(rs, t, **part),
            lambda rs, t, part=part: M.merge_runs_splits_plain(rs, t,
                                                               **part),
            (runs, tab), 4 * M.KWAY * (-(-(n30 // 2) // M.TILE) + 1), as_u32,
            elems=n30 // 2)
        trace_splits(f"2^30 pass, range {ri} of 2",
                     lambda: M.merge_runs_splits(runs, tab, **part))
        trace_merge(f"2^30 pass, range {ri} of 2, 2 streams",
                    2 * 2 * 4 * (n30 // 2),
                    lambda kw=kw: M.merge_pass_runs(runs, tab, **kw))
        check_and_time(
            "merge_pass_runs", f"2^30 pass, range {ri} of 2, 2 streams",
            lambda rs, t, kw=kw: M.merge_pass_runs(rs, t, **kw),
            lambda rs, t, kw=kw: M.merge_pass_runs_plain(rs, t, **kw),
            (runs, tab), 2 * 2 * 4 * (n30 // 2), list, elems=n30 // 2)
    words = torch.cat([order_key([k, r]) for k, r in zip(*runs)])
    del runs, big
    t_lib = time_fn(lambda: torch.sort(words, stable=True))
    del words
    rows["merge_pass_runs"] = {
        "ms": sum(t for t, _ in timed["merge_pass_runs"]),
        "plain_ms": sum(t for _, t in timed["merge_pass_runs"]),
        "bound_ms": bound_ms(2 * 2 * 4 * n30), "bound_by": "bytes",
        "library_ms": t_lib.ms,
        "shape": "2^30 pass (2 ranges of 2^29), 2 streams"}
    print(f"kernel merge_pass_runs [2^30 pass, 2 ranges, 2 streams]: cuda "
          f"{rows['merge_pass_runs']['ms']:.3f} ms, plain "
          f"{rows['merge_pass_runs']['plain_ms']:.3f} ms, library "
          f"{t_lib.ms:.3f} ms (stable torch.sort of 2^30 int64 words), "
          f"bound {rows['merge_pass_runs']['bound_ms']:.3f} ms ({card})")

    # the gather of whole records at sort_records' shape (10^8 gensort
    # records of 100 bytes by a random permutation: 4-byte words) and at a
    # ragged n of 101-byte rows one byte off alignment (bytes); bound: the
    # permutation, each source row read once and each output row written
    # once. The plain version is one torch call (index_select of the rows
    # by the permutation's int32 view)
    gen_r = torch.Generator(device=dev).manual_seed(41)
    for what, rows_, width, offset in (
            ("sort_records: 10^8 rows of 100 bytes", 10**8, 100, 0),
            ("ragged: 101-byte rows, 1 byte off alignment", (1 << 22) + 12345,
             101, 1)):
        buf = torch.randint(0, 256, (rows_ * width + offset,),
                            dtype=torch.uint8, device=dev, generator=gen_r)
        rec = buf[offset:].view(rows_, width)
        perm = torch.randperm(rows_, device=dev, generator=gen_r).to(
            torch.int32).view(torch.uint32)
        got = RC.gather_records(rec, perm)
        if not torch.equal(got, RC.gather_records_plain(rec, perm)):
            raise AssertionError(f"gather_records [{what}]: differs from "
                                 f"its plain version")
        del got
        nbytes = rows_ * (2 * width + 4)
        tk = time_fn(RC.gather_records, rec, perm)
        tp = time_fn(RC.gather_records_plain, rec, perm)
        rows.setdefault("gather_records", {
            "ms": tk.ms, "plain_ms": tp.ms, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": tp.ms,
            "shape": f"{what} n={rows_}"})
        print(f"kernel gather_records [{what}] n={rows_}: bit exact; cuda "
              f"{tk.ms:.3f} ms, plain (index_select) {tp.ms:.3f} ms, bound "
              f"{bound_ms(nbytes):.3f} ms ({nbytes} bytes; at 3.35 TB/s "
              f"{nbytes / 3.35e9:.3f} ms; {card})")
        del buf, rec, perm
    phase_done(5)

    sources = {
        "sort_tiles": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                       "lsdradixsort_tpu/kernels/tile_sort.py:337"),
        "sort_tiles_kv": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                          "lsdradixsort_tpu/kernels/tile_sort.py:238"),
        "sort_tiles_multi": ("lsdradixsort_tpu_torch/csrc/tile_sort.cu",
                             "lsdradixsort_tpu/kernels/tile_sort.py:298"),
        "merge_path_splits": ("lsdradixsort_tpu_torch/csrc/merge.cu",
                              "lsdradixsort_tpu/kernels/merge.py:75"),
        "merge_pass_multi": ("lsdradixsort_tpu_torch/csrc/merge.cu",
                             "lsdradixsort_tpu/kernels/merge.py:626"),
        "merge_pass_runs": ("lsdradixsort_tpu_torch/csrc/merge.cu",
                            "lsdradixsort_tpu/kernels/merge.py:867"),
        "block_digit_histograms": (
            "lsdradixsort_tpu_torch/csrc/histogram.cu",
            "lsdradixsort_tpu/kernels/histogram.py:183"),
        "exclusive_scan": ("lsdradixsort_tpu_torch/csrc/scan.cu",
                           "lsdradixsort_tpu/kernels/scan.py:128"),
        "exclusive_scan_hierarchical": (
            "lsdradixsort_tpu_torch/csrc/scan.cu",
            "lsdradixsort_tpu/kernels/scan.py:181"),
        "block_prefix_sums": ("lsdradixsort_tpu_torch/csrc/scan.cu",
                              "lsdradixsort_tpu/kernels/scan.py:232"),
        "transpose_tiled": ("lsdradixsort_tpu_torch/csrc/transpose.cu",
                            "lsdradixsort_tpu/kernels/transpose.py:48"),
        "compact_stream_multi": (
            "lsdradixsort_tpu_torch/csrc/compaction.cu",
            "lsdradixsort_tpu/kernels/compaction.py:162"),
        "fill_forward_last": ("lsdradixsort_tpu_torch/csrc/fill_forward.cu",
                              "lsdradixsort_tpu/kernels/fill_forward.py:114"),
        "probe_table": ("lsdradixsort_tpu_torch/csrc/hash_table.cu",
                        "lsdradixsort_tpu/kernels/hash_table.py:135"),
        "shuffle_elem_runs": ("lsdradixsort_tpu_torch/csrc/shuffle.cu",
                              "lsdradixsort_tpu/kernels/shuffle.py:175"),
        "shuffle_row_runs": ("lsdradixsort_tpu_torch/csrc/shuffle.cu",
                             "lsdradixsort_tpu/kernels/shuffle.py:235"),
        "filtered_run_sums": ("lsdradixsort_tpu_torch/csrc/aggregate.cu",
                              "lsdradixsort_tpu/ops/aggregate.py:175"),
        "gather_records": ("lsdradixsort_tpu_torch/csrc/records.cu",
                           "none (the JAX package moves no row wider than "
                           "a word)"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k], **rows[k]}
        for k, (src, rep) in sources.items()]}))
    dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
