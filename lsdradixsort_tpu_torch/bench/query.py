"""Query benchmark of the port on one CUDA card: the counterpart of
`suite_query` in lsdradixsort_tpu/bench/runner.py (BASELINE configs 3
and 4).

Data, as there, from fixed seeds on the card: n = 100,000,000 rows (not a
power of two, so every padding path runs) with filter keys in [0, 2^20),
values 0..n-1, group keys in [0, 2^10) and the predicate [2^18, 2^19);
a build side of nb = 10,000,000 keys, a permutation of [0, nb) with
values 3 * key, and probe keys in [0, 2 nb); a many-to-many build side of
nb keys in [0, nb / 4) and max_out = 2 n; a small build side of 1024 keys
of [0, 4096) (values key ^ 0xABC) with probe keys in [0, 4096); top-k of
k = 1024 over full-range keys; unique over the filter keys.

Ops: filter_kv; group_by_sum, filtered_group_by_sum (config 3), hash_join
(config 4) and hash_join_multi with engine "xla" and "merge" (the A/B of
the two grouping sorts); hash_join with engine "vmem" on the small build
side; filter_in_set; top_k; unique.

  python -m lsdradixsort_tpu_torch.bench.query [--verify] [--profile]

--verify checks every op on the card against an independent plain
reference (boolean indexing, `torch.unique` with `index_add_` in int64,
`searchsorted` over the sorted build side, `isin`, a stable descending
sort). --profile traces one more run of each op with torch.profiler and
prints one JSON line per op ({"profile": ..., "kernels", "busy_ms",
"span_ms", "idle_share", "top", "card"}). Then each op is timed (CUDA-event
median of ITERS = 5 after a warm-up) and one JSON line per op is printed:
{"op", "engine", "n", "nb", "ms", "melem_s" (n / ms), "peak_gib" (peak
device memory during one run), "held_gib" (allocated before it), "device",
"card"}. There is no CPU fallback: without a CUDA device it fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Callable

import torch

from lsdradixsort_tpu_torch.bench.flagship import check_keys, profile_kernels
from lsdradixsort_tpu_torch.core.convert import (i64_to_u32, iota_u32,
                                                 u32_to_i64, wrap_u32)
from lsdradixsort_tpu_torch.core.datagen import (random_keys,
                                                 random_keys_bounded)
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
from lsdradixsort_tpu_torch.kernels import aggregate as AG
from lsdradixsort_tpu_torch.kernels import compaction as CP
from lsdradixsort_tpu_torch.kernels import fill_forward as FF
from lsdradixsort_tpu_torch.kernels import hash_table as HT
from lsdradixsort_tpu_torch.kernels import histogram as H
from lsdradixsort_tpu_torch.ops import (filter_in_set, filter_keys, filter_kv,
                                        filter_not_in_set,
                                        filtered_group_by_sum,
                                        group_by_aggregate, group_by_sum,
                                        hash_join, hash_join64,
                                        hash_join_multi, probe_lookup,
                                        probe_lookup64, top_k, unique)

N = 100_000_000
NB = 10_000_000
SMALL_BUILD = 1 << 10
SMALL_RANGE = 1 << 12
TOP_K = 1 << 10
LO, HI = 1 << 18, 1 << 19
ITERS = 5


@dataclass
class Op:
    name: str
    engine: str | None
    run: Callable[[], tuple]
    check: Callable[[tuple], None]
    # kernel -> the calls one run must make (launches, or plain calls on
    # the CPU): the path taken, where that is the point of the op
    calls: dict[str, int] | None = None


def make_data(device="cuda", n: int = N, nb: int = NB) -> dict:
    """Every column the ops read, generated on `device` from fixed seeds."""
    def perm(m, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randperm(m, generator=g, device=device,
                              dtype=torch.int64)

    bkeys = perm(nb, 2)
    small = perm(SMALL_RANGE, 7)[:SMALL_BUILD]
    return {
        "n": n, "nb": nb,
        "keys": random_keys_bounded(n, 0, 1 << 20, 1, device),
        "vals": iota_u32(n, device),
        "gkeys": random_keys_bounded(n, 0, 1 << 10, 7, device),
        "bkeys": i64_to_u32(bkeys),
        "bvals": wrap_u32(3 * bkeys),
        "pkeys": random_keys_bounded(n, 0, 2 * nb, 3, device),
        "bkeys_m": random_keys_bounded(nb, 0, max(nb // 4, 1), 5, device),
        "bkeys_s": i64_to_u32(small),
        "bvals_s": i64_to_u32(small ^ 0xABC),
        "pkeys_s": random_keys_bounded(n, 0, SMALL_RANGE, 8, device),
        "tkeys": random_keys(n, 9, device),
    }


# --- independent plain references ----------------------------------------

def _same(got, want, c: int, label: str) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        check_keys(g[:c], w[:c], f"{label} output {i}")


def _check_count(got_count, want: int, label: str) -> None:
    if int(got_count) != want:
        raise AssertionError(f"{label}: count {int(got_count)}, want {want}")


def _group_sums(gk: torch.Tensor, vals: torch.Tensor):
    """(sorted distinct keys, their sums mod 2^32) by torch.unique and
    index_add_ in int64."""
    uk, inv = torch.unique(u32_to_i64(gk), return_inverse=True)
    sums = torch.zeros_like(uk).index_add_(0, inv, u32_to_i64(vals))
    return i64_to_u32(uk), wrap_u32(sums)


def _check_selection(sel, columns, out, label):
    """(count, *columns compacted by sel) by boolean indexing."""
    want = [c.view(torch.int32)[sel] for c in columns]
    _check_count(out[0], want[0].shape[0], label)
    _same([o.view(torch.int32) for o in out[1:]], want, want[0].shape[0],
          label)


def _in_range(keys):
    k = u32_to_i64(keys)
    return (k >= LO) & (k < HI)


def _check_groups(gk, vals, out, label):
    uk, sums = _group_sums(gk, vals)
    _check_count(out[0], uk.shape[0], label)
    _same(out[1:], [uk, sums], uk.shape[0], label)


def _check_filtered_groups(d, out, label):
    sel = _in_range(d["keys"])
    _check_groups(d["gkeys"].view(torch.int32)[sel].view(torch.uint32),
                  d["vals"].view(torch.int32)[sel].view(torch.uint32), out,
                  label)


def _as_i64(x):
    """u32 or i32 values as int64 in their own order."""
    return u32_to_i64(x) if x.dtype == torch.uint32 else x.to(torch.int64)


def _from_i64(v, dtype):
    return i64_to_u32(v) if dtype == torch.uint32 else v.to(dtype)


def _check_reduce(gk, vals, reduction, out, label):
    """SUM / MIN / MAX / COUNT per group by torch.unique, index_add_ (sums
    mod 2^32) and scatter_reduce_ (u32/i32 keys; u32/i32 values, f32 for
    MIN and MAX)."""
    uk, inv, counts = torch.unique(_as_i64(gk), return_inverse=True,
                                   return_counts=True)
    if reduction == "count":
        want = i64_to_u32(counts)
    elif reduction == "sum":
        want = wrap_u32(torch.zeros_like(uk).index_add_(0, inv, _as_i64(vals))
                        ).view(vals.dtype)
    else:
        v = vals if vals.dtype == torch.float32 else _as_i64(vals)
        want = torch.empty(uk.shape[0], dtype=v.dtype, device=v.device)
        want.scatter_reduce_(0, inv, v, "amin" if reduction == "min"
                             else "amax", include_self=False)
        if vals.dtype != torch.float32:
            want = _from_i64(want, vals.dtype)
    _check_count(out[0], uk.shape[0], label)
    _same(out[1:], [_from_i64(uk, gk.dtype), want], uk.shape[0], label)


def _lookup(bk, bv, pk):
    """(hit, build value) of each probe against unique build keys: a
    searchsorted over the sorted build side (bk may be an int64 key)."""
    sb, order = torch.sort(bk if bk.dtype == torch.int64 else u32_to_i64(bk))
    p = pk if pk.dtype == torch.int64 else u32_to_i64(pk)
    at = torch.searchsorted(sb, p).clamp(max=sb.shape[0] - 1)
    hit = sb[at] == p
    return hit, torch.where(hit, bv.view(torch.int32)[order[at]], 0)


def _check_join(bk, bv, pk, pv, out, label):
    """Unique build keys: searchsorted over the sorted build side."""
    hit, bval = _lookup(bk, bv, pk)
    _check_selection(hit, [pk, pv, bval], out, label)


def _check_lookup(bk, bv, pk, out, label):
    hit, bval = _lookup(bk, bv, pk)
    check_keys(out[0], hit.to(torch.int32).view(torch.uint32),
               f"{label} match")
    check_keys(out[1], bval.view(torch.uint32), f"{label} build_val")


def _key64(hi, lo):
    """(hi, lo) uint32 planes as one int64 in the unsigned order."""
    return (u32_to_i64(hi) - (1 << 31)) * (1 << 32) + u32_to_i64(lo)


def _check_join64(bhi, blo, bv, phi, plo, pv, out):
    hit, bval = _lookup(_key64(bhi, blo), bv, _key64(phi, plo))
    _check_selection(hit, [phi, plo, pv, bval], out, "hash_join64")


def _check_join_multi(bk, bv, pk, pv, max_out, out, label, valid=None,
                      build_idx=False):
    """Duplicate build keys: each probe's run of the stably sorted build
    side, expanded with repeat_interleave. pv may be a tuple of streams;
    valid masks probe rows out; build_idx checks the index into the
    stably sorted build side that out carries last."""
    sb, order = torch.sort(u32_to_i64(bk), stable=True)
    p = u32_to_i64(pk)
    lo = torch.searchsorted(sb, p, side="left")
    length = torch.searchsorted(sb, p, side="right") - lo
    if valid is not None:
        length = torch.where(valid, length, 0)
    total = int(length.sum())
    _check_count(out[0], total, label)
    c = min(total, max_out)
    row = torch.repeat_interleave(torch.arange(p.shape[0], device=p.device),
                                  length)[:c]
    first = torch.cumsum(length, 0) - length
    sidx = lo[row] + torch.arange(c, device=p.device) - first[row]
    pvs, got_pv = ((pv, out[2]) if isinstance(pv, tuple)
                   else ((pv,), (out[2],)))
    want = [pk.view(torch.int32)[row],
            *(v.view(torch.int32)[row] for v in pvs),
            bv.view(torch.int32)[order[sidx]]]
    got = [out[1], *got_pv, out[3]]
    if build_idx:
        want.append(sidx.to(torch.int32))
        got.append(out[4])
    _same([g.view(torch.int32) for g in got], want, c, label)


def _check_top_k(keys, k, largest, out, label):
    _, idx = torch.sort(u32_to_i64(keys), descending=largest, stable=True)
    idx = idx[:k]
    check_keys(out[0], keys.view(torch.int32)[idx].view(torch.uint32),
               f"{label} values")
    check_keys(out[1], idx.to(torch.int32).view(torch.uint32),
               f"{label} indices")


def _check_unique(keys, out, label):
    uk, counts = torch.unique(u32_to_i64(keys), return_counts=True)
    _check_count(out[0], uk.shape[0], label)
    _same(out[1:], [i64_to_u32(uk), i64_to_u32(counts)], uk.shape[0], label)


def query_ops(d: dict) -> list[Op]:
    """The benchmark's ops on data from `make_data`, each with its check."""
    n = d["n"]
    ops = [Op("filter_kv", None,
              lambda: filter_kv(d["keys"], d["vals"], LO, HI),
              lambda out: _check_selection(_in_range(d["keys"]),
                                           [d["keys"], d["vals"]], out,
                                           "filter_kv"))]
    for engine in ("xla", "merge"):
        ops += [
            Op("group_by_sum", engine,
               lambda e=engine: group_by_sum(d["keys"], d["vals"], engine=e),
               lambda out, e=engine: _check_groups(
                   d["keys"], d["vals"], out, f"group_by_sum {e}")),
            Op("filtered_group_by_sum", engine,
               lambda e=engine: filtered_group_by_sum(
                   d["keys"], d["gkeys"], d["vals"], LO, HI, engine=e),
               lambda out, e=engine: _check_filtered_groups(
                   d, out, f"filtered_group_by_sum {e}"),
               {"filtered_run_sums": 1, "compact_stream_multi": 0}),
            Op("hash_join", engine,
               lambda e=engine: hash_join(d["bkeys"], d["bvals"], d["pkeys"],
                                          d["vals"], engine=e),
               lambda out, e=engine: _check_join(
                   d["bkeys"], d["bvals"], d["pkeys"], d["vals"], out,
                   f"hash_join {e}")),
            Op("hash_join_multi", engine,
               lambda e=engine: hash_join_multi(
                   d["bkeys_m"], d["bvals"], d["pkeys"], d["vals"],
                   max_out=2 * n, engine=e),
               lambda out, e=engine: _check_join_multi(
                   d["bkeys_m"], d["bvals"], d["pkeys"], d["vals"], 2 * n,
                   out, f"hash_join_multi {e}")),
        ]
    ops += [
        Op("hash_join", "vmem",
           lambda: hash_join(d["bkeys_s"], d["bvals_s"], d["pkeys_s"],
                             d["vals"], engine="vmem"),
           lambda out: _check_join(d["bkeys_s"], d["bvals_s"], d["pkeys_s"],
                                   d["vals"], out, "hash_join vmem")),
        Op("filter_in_set", None,
           lambda: filter_in_set(d["pkeys_s"], d["bkeys_s"], d["vals"]),
           lambda out: _check_selection(
               torch.isin(u32_to_i64(d["pkeys_s"]), u32_to_i64(d["bkeys_s"])),
               [d["pkeys_s"], d["vals"]], out, "filter_in_set")),
        Op("top_k", None, lambda: top_k(d["tkeys"], TOP_K, largest=True),
           lambda out: _check_top_k(d["tkeys"], TOP_K, True, out, "top_k")),
        Op("unique", None, lambda: unique(d["keys"]),
           lambda out: _check_unique(d["keys"], out, "unique")),
    ]
    return ops


def one_lane_keys(m: int, device) -> torch.Tensor:
    """m distinct uint32 keys that all hash to lane 0 of the hash table,
    so a table of plan_rows(m) rows overflows and the vmem engines take
    their fallback (the first m such integers; about 1 in 128 is one)."""
    cand = torch.arange(256 * m, device=device)
    return i64_to_u32(cand[HT.lane_of(i64_to_u32(cand)) == 0][:m])


def entry_point_ops(d: dict) -> list[Op]:
    """The query entry points and paths `query_ops` does not time, each
    with its plain reference and, where the path is the point, the kernel
    calls one run must make: filter_keys; NOT IN; IN and NOT IN, the vmem
    join and lookup past the hash table's chains (their fallbacks);
    probe_lookup in all three engines; the 64-bit lookup and join; MIN,
    MAX and COUNT in both engines and on i32/f32 columns;
    hash_join_multi's options and truncation; top_k's fast path; unique
    below its merge threshold. Made for make_data(n=2^22, nb=2^18)."""
    n, dev = d["n"], d["keys"].device
    over = one_lane_keys(SMALL_BUILD, dev)
    over_vals = wrap_u32(u32_to_i64(over) * 5)
    pover = random_keys_bounded(n, 0, 256 * SMALL_BUILD, 10, dev)
    # 64-bit keys: lo the build keys, hi a hash of lo; half the probes
    # carry a wrong hi and so match on lo alone, which must not count
    bhi = wrap_u32(u32_to_i64(d["bkeys"]) * HT.MIX)
    phi = wrap_u32(u32_to_i64(d["pkeys"]) * HT.MIX
                   + (torch.arange(n, device=dev) & 1))
    ikeys = d["gkeys"].view(torch.int32) - 512           # i32 groups
    ivals = d["tkeys"].view(torch.int32)
    fvals = torch.randn(n, generator=torch.Generator(device=dev)
                        .manual_seed(11), device=dev)
    valid = (torch.arange(n, device=dev) % 3) != 0
    small = d["keys"][:100_000]
    in_set = torch.isin(u32_to_i64(d["pkeys_s"]), u32_to_i64(d["bkeys_s"]))
    in_over = torch.isin(u32_to_i64(pover), u32_to_i64(over))
    probe, vmem_probe = {"probe_table": 1}, {"probe_table": 0}
    ops = [
        Op("filter_keys", None, lambda: filter_keys(d["keys"], LO, HI),
           lambda out: _check_selection(_in_range(d["keys"]), [d["keys"]],
                                        out, "filter_keys")),
        Op("filter_not_in_set", None,
           lambda: filter_not_in_set(d["pkeys_s"], d["bkeys_s"], d["vals"]),
           lambda out: _check_selection(in_set.logical_not(),
                                        [d["pkeys_s"], d["vals"]], out,
                                        "filter_not_in_set"), probe),
        Op("filter_in_set", "chain overflow",
           lambda: filter_in_set(pover, over, d["vals"]),
           lambda out: _check_selection(in_over, [pover, d["vals"]], out,
                                        "filter_in_set overflow"),
           vmem_probe),
        Op("filter_not_in_set", "chain overflow",
           lambda: filter_not_in_set(pover, over, d["vals"]),
           lambda out: _check_selection(in_over.logical_not(),
                                        [pover, d["vals"]], out,
                                        "filter_not_in_set overflow"),
           vmem_probe),
        Op("hash_join", "vmem, chain overflow",
           lambda: hash_join(over, over_vals, pover, d["vals"],
                             engine="vmem"),
           lambda out: _check_join(over, over_vals, pover, d["vals"], out,
                                   "hash_join vmem overflow"),
           {"probe_table": 0, "fill_forward_last": 1}),
        Op("probe_lookup", "vmem",
           lambda: probe_lookup(d["bkeys_s"], d["bvals_s"], d["pkeys_s"],
                                engine="vmem"),
           lambda out: _check_lookup(d["bkeys_s"], d["bvals_s"],
                                     d["pkeys_s"], out, "probe_lookup vmem"),
           {"probe_table": 1, "fill_forward_last": 0}),
        Op("probe_lookup", "vmem, chain overflow",
           lambda: probe_lookup(over, over_vals, pover, engine="vmem"),
           lambda out: _check_lookup(over, over_vals, pover, out,
                                     "probe_lookup vmem overflow"),
           {"probe_table": 0, "fill_forward_last": 1}),
        Op("probe_lookup64", None,
           lambda: probe_lookup64(bhi, d["bkeys"], d["bvals"], phi,
                                  d["pkeys"]),
           lambda out: _check_lookup(_key64(bhi, d["bkeys"]), d["bvals"],
                                     _key64(phi, d["pkeys"]), out,
                                     "probe_lookup64"),
           {"fill_forward_last": 2}),
        Op("hash_join64", None,
           lambda: hash_join64(bhi, d["bkeys"], d["bvals"], phi, d["pkeys"],
                               d["vals"]),
           lambda out: _check_join64(bhi, d["bkeys"], d["bvals"], phi,
                                     d["pkeys"], d["vals"], out),
           {"fill_forward_last": 2, "compact_stream_multi": 1}),
    ]
    for engine in ("xla", "merge"):
        ops.append(Op("probe_lookup", engine,
                      lambda e=engine: probe_lookup(d["bkeys"], d["bvals"],
                                                    d["pkeys"], engine=e),
                      lambda out, e=engine: _check_lookup(
                          d["bkeys"], d["bvals"], d["pkeys"], out,
                          f"probe_lookup {e}"),
                      {"probe_table": 0, "fill_forward_last": 1}))
        for red in ("min", "max", "count"):
            ops.append(Op(
                "group_by_aggregate", f"{red} {engine}",
                lambda e=engine, r=red: group_by_aggregate(
                    d["gkeys"], d["tkeys"], reduction=r, engine=e),
                lambda out, e=engine, r=red: _check_reduce(
                    d["gkeys"], d["tkeys"], r, out,
                    f"group_by_aggregate {r} {e}")))
    for red, vals in (("sum", ivals), ("min", ivals), ("max", fvals)):
        ops.append(Op(
            "group_by_aggregate", f"{red} xla, i32 keys, {vals.dtype} values",
            lambda r=red, v=vals: group_by_aggregate(ikeys, v, reduction=r),
            lambda out, r=red, v=vals: _check_reduce(
                ikeys, v, r, out, f"group_by_aggregate {r} i32 keys")))
    ops += [
        Op("hash_join_multi", "xla, 2 probe streams, probe_valid, build_idx",
           lambda: hash_join_multi(
               d["bkeys_m"], d["bvals"], d["pkeys"], (d["vals"], d["tkeys"]),
               max_out=2 * n, probe_valid=valid, return_build_idx=True),
           lambda out: _check_join_multi(
               d["bkeys_m"], d["bvals"], d["pkeys"], (d["vals"], d["tkeys"]),
               2 * n, out, "hash_join_multi options", valid=valid,
               build_idx=True)),
        Op("hash_join_multi", "merge, truncated at max_out = n / 4",
           lambda: hash_join_multi(d["bkeys_m"], d["bvals"], d["pkeys"],
                                   d["vals"], max_out=n // 4,
                                   engine="merge"),
           lambda out: _check_join_multi(
               d["bkeys_m"], d["bvals"], d["pkeys"], d["vals"], n // 4, out,
               "hash_join_multi truncated")),
        Op("top_k", "fast path, largest",
           lambda: top_k(d["tkeys"], TOP_K, largest=True),
           lambda out: _check_top_k(d["tkeys"], TOP_K, True, out,
                                    "top_k fast largest"),
           {"block_digit_histograms": 1, "compact_stream_multi": 1}),
        Op("top_k", "fast path, smallest",
           lambda: top_k(d["tkeys"], TOP_K, largest=False),
           lambda out: _check_top_k(d["tkeys"], TOP_K, False, out,
                                    "top_k fast smallest"),
           {"block_digit_histograms": 1, "compact_stream_multi": 1}),
        Op("unique", "below 2^17 rows", lambda: unique(small),
           lambda out: _check_unique(small, out, "unique small")),
    ]
    return ops


def label(op: Op) -> str:
    return op.name if op.engine is None else f"{op.name} {op.engine}"


def kernel_calls() -> dict[str, int]:
    """Launches plus plain calls of each query-path kernel so far."""
    return {k: mod.LAUNCHES[k] + mod.PLAIN_CALLS[k]
            for mod in (AG, CP, FF, HT, H) for k in mod.LAUNCHES}


def run_once(op: Op, check: bool) -> tuple[float, float]:
    """Run op once (and check it, and the kernel calls it made where
    op.calls names them) and return (peak, held) device memory in GiB:
    the peak during the run, and what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = kernel_calls()
    out = op.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if check:
        op.check(out)
        made = {k: v - before[k] for k, v in kernel_calls().items()}
        for k, want in (op.calls or {}).items():
            if made[k] != want:
                raise AssertionError(f"{label(op)}: {made[k]} calls of {k}, "
                                     f"want {want} (the path not taken)")
    return peak / 2**30, held / 2**30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("query: no CUDA device", file=sys.stderr)
        return 1
    d = make_data("cuda")
    ops = query_ops(d)
    card = card_label()
    memory = {}
    for op in ops:
        memory[label(op)] = run_once(op, check=args.verify)
        if args.verify:
            print(f"# verify: {label(op)} OK", flush=True)
    if args.profile:
        for op in ops:
            print(json.dumps({**profile_kernels(label(op), op.run),
                              "card": card}), flush=True)
    for op in ops:
        t = time_fn(op.run, iters=ITERS)
        peak, held = memory[label(op)]
        print(json.dumps({
            "op": op.name, "engine": op.engine, "n": d["n"], "nb": d["nb"],
            "ms": t.ms, "melem_s": d["n"] / t.seconds / 1e6,
            "peak_gib": peak, "held_gib": held,
            "device": torch.cuda.get_device_name(0), "card": card}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
