"""Hash join and lookups — the port of lsdradixsort_tpu/ops/join.py (north
star config 4: build 10M / probe 100M uint32 keys).

A sort-merge join, as in the JAX package: build and probe rows are
concatenated, build first, with a packed (tag << 31) | position column
(tag 0 for build rows, 1 for probe rows); one sort by key puts each probe
row right after the build row of its key, if any; the fill-forward
(kernels/fill_forward.py) hands each probe row the nearest build row
before it, which is its match iff the keys are equal; a last sort by
probe position brings the matches back into probe order.

The JAX `lax.sort` calls become stable torch sorts by the keys alone,
which is exact: in each main sort the packed column is unique and
ascends in concatenation order, so a stable sort by key equals the JAX
sort by (key, packed); in each final sort the keys are unique on the rows
that are defined. engine="merge" runs the main sort through the port's
framework sort (ops/sort.py `_sort_rows`, which compares (key, packed)).
engine="vmem" probes the lane-bucketed hash table
(kernels/hash_table.py) for small build sides; when a chain overflows the
planned depth it runs the "xla" join instead, as the JAX package's
`lax.cond` does (here one host sync on `ok`).

Outputs keep the JAX package's lengths; rows past the count are
unspecified. Positions must stay below 2^31 (n_build + n_probe < 2^31).
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core.convert import (gather, iota_u32,
                                                 stable_order, u32_to_i64,
                                                 wrap_u32)
from lsdradixsort_tpu_torch.core.profiling import annotate, host_value
from lsdradixsort_tpu_torch.kernels.fill_forward import fill_forward_last
from lsdradixsort_tpu_torch.kernels.hash_table import (build_table,
                                                       plan_rows,
                                                       probe_table)
from lsdradixsort_tpu_torch.kernels.scan import exclusive_scan
from lsdradixsort_tpu_torch.ops.aggregate import starts_run
from lsdradixsort_tpu_torch.ops.filter import compact
from lsdradixsort_tpu_torch.ops.sort import _sort_rows

_SIGN = -(1 << 31)          # 0x80000000 as int32 bits
_LOW = 0x7FFFFFFF


def _tagged_positions(nb: int, np_: int, device) -> torch.Tensor:
    """The packed column: build rows 0..nb-1, probe rows 2^31 | 0..np_-1."""
    return torch.cat([torch.arange(nb, dtype=torch.int32, device=device),
                      torch.arange(np_, dtype=torch.int32, device=device)
                      | _SIGN]).view(torch.uint32)


def _probe_order(matched_or_probe: torch.Tensor,
                 spacked: torch.Tensor) -> torch.Tensor:
    """Order that brings the selected rows to the front by probe position
    (the rest after them)."""
    with annotate("lsd.join.probe_order"):
        pos = spacked.view(torch.int32) & _LOW
        key = torch.where(matched_or_probe, pos, _LOW)
        return torch.sort(key, stable=True).indices


def _sort_merge_match(keys, packed, val, engine, tile_log2):
    """The join's core on (key, packed, val) rows: (sk, spacked, sval,
    is_build, matched, build_val)."""
    sk, (spacked,), (sval,) = _sort_rows(keys, [packed], [val], engine,
                                         tile_log2, key_only=True)
    with annotate("lsd.join.match"):
        is_build = spacked.view(torch.int32) >= 0
        bk_fill, seg_bval, has_build = fill_forward_last(is_build, sk, sval)
        matched = (is_build.logical_not() & (has_build.view(torch.int32) == 1)
                   & (bk_fill.view(torch.int32) == sk.view(torch.int32)))
    return sk, spacked, sval, is_build, matched, seg_bval


def hash_join(build_keys: torch.Tensor, build_vals: torch.Tensor,
              probe_keys: torch.Tensor, probe_vals: torch.Tensor,
              engine: str = "xla", tile_log2: int = 15):
    """Inner equi-join on uint32 keys, unique build keys. Returns (count,
    probe_keys, probe_vals, build_vals) in probe order, probe length; rows
    past count are unspecified."""
    with annotate("lsd.hash_join"):
        nb, np_ = build_keys.shape[0], probe_keys.shape[0]
        if engine == "vmem":
            tk, tv, cnt, ok = build_table(build_keys, build_vals,
                                          plan_rows(nb))
            if host_value(ok):
                match, bval = probe_table(tk, tv, cnt, probe_keys)
                return compact(match.view(torch.int32) == 1, probe_keys,
                               probe_vals, bval)
            return hash_join(build_keys, build_vals, probe_keys, probe_vals,
                             engine="xla", tile_log2=tile_log2)
        with annotate("lsd.join.tag"):
            keys = torch.cat([build_keys, probe_keys])
            packed = _tagged_positions(nb, np_, keys.device)
            val = torch.cat([build_vals, probe_vals])
        sk, spacked, sval, _, matched, seg_bval = _sort_merge_match(
            keys, packed, val, engine, tile_log2)
        del keys, packed, val
        count = wrap_u32(matched.sum())
        order = _probe_order(matched, spacked)[:np_]
        with annotate("lsd.join.gather"):
            return (count, gather(sk, order), gather(sval, order),
                    gather(seg_bval, order))


def probe_lookup(build_keys: torch.Tensor, build_vals: torch.Tensor,
                 probe_keys: torch.Tensor, engine: str = "xla",
                 tile_log2: int = 15):
    """For every probe row, in probe order: (match uint32 0/1, build_val,
    0 where unmatched). Unique build keys. Engines as in hash_join."""
    with annotate("lsd.probe_lookup"):
        nb, np_ = build_keys.shape[0], probe_keys.shape[0]
        if engine == "vmem":
            tk, tv, cnt, ok = build_table(build_keys, build_vals,
                                          plan_rows(nb))
            if host_value(ok):
                return probe_table(tk, tv, cnt, probe_keys)
            return probe_lookup(build_keys, build_vals, probe_keys,
                                engine="xla", tile_log2=tile_log2)
        with annotate("lsd.join.tag"):
            keys = torch.cat([build_keys, probe_keys])
            packed = _tagged_positions(nb, np_, keys.device)
            val = torch.cat([build_vals, torch.zeros_like(probe_keys)])
        _, spacked, _, is_build, matched, seg_bval = _sort_merge_match(
            keys, packed, val, engine, tile_log2)
        del keys, packed, val
        return _lookup_result(is_build, matched, seg_bval, spacked, np_)


def _lookup_result(is_build, matched, seg_bval, spacked, np_: int):
    """(match, build_val) of the probe rows, back in probe order."""
    order = _probe_order(is_build.logical_not(), spacked)[:np_]
    with annotate("lsd.join.gather"):
        m = matched[order].to(torch.int32).view(torch.uint32)
        bv = torch.where(matched, seg_bval.view(torch.int32), 0)[order]
        return m, bv.view(torch.uint32)


def probe_lookup64(build_hi: torch.Tensor, build_lo: torch.Tensor,
                   build_vals: torch.Tensor, probe_hi: torch.Tensor,
                   probe_lo: torch.Tensor):
    """probe_lookup on 64-bit keys given as (hi, lo) uint32 planes: per
    probe row, (match, build_val) in probe order. Unique build keys; both
    planes must be equal for a match."""
    nb, np_ = build_hi.shape[0], probe_hi.shape[0]
    hi = torch.cat([build_hi, probe_hi])
    lo = torch.cat([build_lo, probe_lo])
    packed = _tagged_positions(nb, np_, hi.device)
    val = torch.cat([build_vals, torch.zeros_like(probe_hi)])
    perm = stable_order([hi, lo])
    shi, slo, spacked, sval = (gather(x, perm) for x in (hi, lo, packed, val))
    del perm, hi, lo, packed, val
    is_build = spacked.view(torch.int32) >= 0
    hi_fill, seg_bval, has_build = fill_forward_last(is_build, shi, sval)
    lo_fill, _, _ = fill_forward_last(is_build, slo, sval)
    matched = (is_build.logical_not() & (has_build.view(torch.int32) == 1)
               & (hi_fill.view(torch.int32) == shi.view(torch.int32))
               & (lo_fill.view(torch.int32) == slo.view(torch.int32)))
    return _lookup_result(is_build, matched, seg_bval, spacked, np_)


def hash_join64(build_hi: torch.Tensor, build_lo: torch.Tensor,
                build_vals: torch.Tensor, probe_hi: torch.Tensor,
                probe_lo: torch.Tensor, probe_vals: torch.Tensor):
    """Inner equi-join on 64-bit keys as (hi, lo) uint32 planes, unique
    build keys. Returns (count, probe_hi, probe_lo, probe_vals,
    build_vals) in probe order; rows past count are unspecified."""
    m, bv = probe_lookup64(build_hi, build_lo, build_vals, probe_hi,
                           probe_lo)
    return compact(m.view(torch.int32) == 1, probe_hi, probe_lo, probe_vals,
                   bv)


def hash_join_multi(build_keys: torch.Tensor, build_vals: torch.Tensor,
                    probe_keys: torch.Tensor, probe_vals, max_out: int,
                    engine: str = "xla", tile_log2: int = 15,
                    probe_valid: torch.Tensor | None = None,
                    return_build_idx: bool = False):
    """Inner equi-join with duplicate build keys allowed (many-to-many).

    Probe-major output: for each probe row in input order, one row per
    matching build row, those in stable build order. Returns (count,
    probe_keys, probe_vals, build_vals), each max_out long; rows past
    min(count, max_out) are unspecified, and count is the untruncated
    total. probe_vals may be a tuple of uint32 streams (returned as a
    tuple); probe_valid masks probe rows out; return_build_idx appends
    each output row's index into the stable-sorted build side.

    The sorted build side is described per run by (start, length); each
    probe row picks up its run through the fill-forward, and the output
    rows are decoded from an exclusive scan of the hit probes' lengths
    with a searchsorted."""
    single = not isinstance(probe_vals, (tuple, list))
    pvals = (probe_vals,) if single else tuple(probe_vals)
    nb, np_ = build_keys.shape[0], probe_keys.shape[0]
    dev = build_keys.device

    perm = stable_order([build_keys])
    sbk, sbv = gather(build_keys, perm), gather(build_vals, perm)
    del perm
    bpos = iota_u32(nb, dev)
    _, run_start, _ = fill_forward_last(starts_run(sbk), sbk, bpos)
    run_len = wrap_u32(u32_to_i64(bpos) - u32_to_i64(run_start) + 1)
    # build and probe rows are disjoint, so streams 1 and 2 carry
    # (run_start, run_len) on build rows and (probe_vals[0], valid) on
    # probe rows; further probe streams ride with zeros on build rows
    valid = (torch.ones(np_, dtype=torch.int32, device=dev)
             if probe_valid is None
             else probe_valid.to(torch.int32)).view(torch.uint32)
    keys = torch.cat([sbk, probe_keys])
    packed = _tagged_positions(nb, np_, dev)
    streams = [torch.cat([run_start, pvals[0]]), torch.cat([run_len, valid]),
               *(torch.cat([torch.zeros_like(bpos), pv]) for pv in pvals[1:])]
    del run_start, run_len, valid
    sk, (spacked,), (s1, s2, *sex) = _sort_rows(keys, [packed], streams,
                                                engine, tile_log2,
                                                key_only=True)
    del keys, packed, streams
    is_build = spacked.view(torch.int32) >= 0
    bk_fill, f_start, has_build = fill_forward_last(is_build, sk, s1)
    _, f_len, _ = fill_forward_last(is_build, sk, s2)
    matched = (is_build.logical_not() & (has_build.view(torch.int32) == 1)
               & (bk_fill.view(torch.int32) == sk.view(torch.int32)))
    if probe_valid is not None:
        matched &= s2.view(torch.int32) == 1     # s2: validity on probes
    del bk_fill, has_build
    lens = torch.where(matched, f_len.view(torch.int32), 0)
    order = _probe_order(matched, spacked)
    del matched, spacked, is_build
    cpk, cpv, cstart, clen = (gather(x, order) for x in (sk, s1, f_start,
                                                          lens))
    cex = [gather(x, order) for x in sex]
    del order, sk, s1, s2, f_start, f_len, lens, sex
    clen = clen.view(torch.uint32)
    count = wrap_u32(u32_to_i64(clen).sum())
    # output row j belongs to the hit probe r with offs[r] <= j <
    # offs[r] + clen[r]; offsets rise strictly over the hits (len >= 1)
    # and stay flat after them, so r is a searchsorted
    offs = u32_to_i64(exclusive_scan(clen))
    j = torch.arange(max_out, device=dev)
    r = (torch.searchsorted(offs, j, side="right") - 1).clamp(min=0)
    bidx = (u32_to_i64(cstart)[r] + j - offs[r]).clamp(max=max(nb - 1, 0))
    del offs, j
    out_pv = (gather(cpv, r) if single
              else tuple(gather(c, r) for c in (cpv, *cex)))
    out = (count, gather(cpk, r), out_pv, gather(sbv, bidx))
    return out + (wrap_u32(bidx),) if return_build_idx else out
