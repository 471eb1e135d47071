"""Chip-scale chunked sort — the port of lsdradixsort_tpu/ops/bigsort.py:
the memory plan that sorts 2^30 kv rows stably on one device (north-star
config 1; the reference's flagship TestGPULSDRadixSort,
LSDRadixSort.cu:912-1030, lifted to stable kv).

  1. The input arrives as S equal SEGMENTS (chunked columns). Each is
     stably sorted on its own by the merge engine (ops/sort.py
     `_merge_chain`, the global position base + iota the compared
     payload), so only one segment's pass buffers are live beyond the
     data itself. The caller's
     segment lists are emptied as the segments are consumed (the JAX
     package donates them): a caller that holds no other reference frees
     each segment once it is sorted.
  2. The final S-way merge runs CHUNKED: exact-rank boundaries
     (kernels/merge.py `merge_tables_exact_runs`) make every chunk exactly
     chunk_elems rows, so the pass splits into `nranges` separately
     allocated output ranges, each one launch of the `merge_pass_runs`
     kernel, which reads the S runs from S separate buffers.
  3. Between ranges each run's consumed prefix is TRIMMED (a suffix copy
     at quarter-run granularity), which frees device memory as output
     accumulates and leaves the kernel runs of different lengths.

The port's merge has no buffer capacity, so no chunk can overflow it: the
JAX package's host overflow check, its gather + sort fallback
(`_chunk_fallback_fn`) and the patch of fallback chunks into a range have
nothing to guard and are not ported, and skewed inputs go through the
kernel. That also leaves nothing to crash on runs shorter than a chunk
plus two table blocks, where the JAX fallback does (ROADMAP Queue C 1).
The TPU knobs (buf_elems, ce, pipeline, interpret) are accepted and
change nothing; blk sets the table's window granularity, as there.

Output is returned as range-chunked columns (concatenating would itself
allocate the output twice — callers stream the ranges).

Tracing: with `TRACE` set to a list, every phase end (each segment sort,
the tables, each range, each trim) appends (label, CUDA event) when the
data is on the card; bench/flagship.py reads the phase times from them.
LSD_DEBUG=1 prints each phase with the device memory allocated to stderr.
"""
from __future__ import annotations

import os
import sys
import time

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32
from lsdradixsort_tpu_torch.core.profiling import to_host
from lsdradixsort_tpu_torch.kernels import merge as M
from lsdradixsort_tpu_torch.ops.sort import _merge_chain

LANES = 128
TRACE: list | None = None


def _debug(msg: str) -> None:
    """Progress prints for chip-scale runs, gated by LSD_DEBUG=1, with the
    device memory allocated when a card is in use."""
    if os.environ.get("LSD_DEBUG") == "1":
        mem = ""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            mem = f" [allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB]"
        stamp = (time.strftime("%H:%M:%S")
                 + f".{int(time.time() * 1000) % 1000:03d}")
        print(f"# bigsort {stamp} {msg}{mem}", file=sys.stderr, flush=True)


def _phase(label: str, dev: torch.device) -> None:
    """Mark the end of a phase (see the module docstring)."""
    if TRACE is not None and dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        TRACE.append((label, ev))
    _debug(label)


def merge_runs_chunked(run_streams, *, chunk_log2: int = 19,
                       nranges: int = 2, blk: int = M.DEF_BLK,
                       buf_elems: int = M.DEF_BUF, trim: bool = True,
                       ce: str = "reshape", pipeline="full",
                       interpret: bool | None = None,
                       range_consumer=None, consume_inputs: bool = False,
                       fanout: int | None = None):
    """Merge S sorted runs (each stream a list of S separate equal-length
    uint32 buffers) into `nranges` output ranges, trimming consumed input
    between ranges. run_streams[0] = keys; run_streams[1] = val0 (the
    position-consistent tiebreak, REQUIRED: exact boundaries count ties in
    run order); further streams ride. Returns a list over streams of lists
    over ranges.

    range_consumer: optional fn(ri, outs) called as each range completes,
    with outs = [one tensor per stream]. The range buffers are then
    released after the call instead of accumulated, and the return value
    is ONE list (in out[0]) of the fn's per-range results; the other
    streams' lists are empty.

    consume_inputs=True also CLEARS the passed run_streams lists: the
    caller's lists would otherwise keep every untrimmed run buffer alive
    for the whole call, and the trims would free nothing.
    """
    ns = len(run_streams)
    S = len(run_streams[0])
    if not 2 <= S <= M.KWAY:
        raise ValueError(f"need 2..{M.KWAY} runs, got {S}")
    dev = run_streams[0][0].device
    L = run_streams[0][0].shape[0]
    C = 1 << chunk_log2
    nch = S * L // C
    if nch % nranges:
        raise ValueError(f"nranges={nranges} must divide nchunks={nch}")

    _debug(f"exact-rank tables: S={S} nchunks={nch}")
    tab, _ = M.merge_tables_exact_runs(run_streams[0], C, blk=blk,
                                       fanout=fanout)
    tab = to_host(tab)                    # (nch+pad+8, NCOLS), tiny
    _phase("tables", dev)

    streams = [list(rs) for rs in run_streams]
    if consume_inputs:
        for rs in run_streams:
            rs.clear()
    del run_streams
    trims = torch.zeros(S, dtype=torch.int32)   # 128-row units trimmed
    rng_ch = nch // nranges
    out = [[] for _ in range(ns)]
    for ri in range(nranges):
        c0 = ri * rng_ch
        adj = tab.clone()
        adj[:, :S] -= trims[None, :]
        _debug(f"range {ri}/{nranges}: merge_pass_runs chunks "
               f"[{c0},{c0 + rng_ch}) run_lens="
               f"{[int(r.shape[0]) for r in streams[0]]}")
        outs = M.merge_pass_runs(
            streams, adj, chunk0=c0, nchunks=rng_ch, chunk_elems=C,
            buf_elems=buf_elems, blk=blk, ce=ce, pipeline=pipeline,
            interpret=interpret)
        _phase(f"range {ri}", dev)
        if range_consumer is not None:
            res = range_consumer(ri, outs)
            del outs
            out[0].append(res)
        else:
            for g in range(ns):
                out[g].append(outs[g])
        if trim and ri + 1 < nranges:
            # free each run's consumed prefix (quarter-run granularity,
            # at least one quarter kept); the suffix copy replaces the
            # buffer, which is freed when nothing else holds it
            Lr = L // LANES
            for s in range(S):
                consumed = int(tab[c0 + rng_ch, s])          # 128-row units
                t_new = min((consumed // (Lr // 4)) * (Lr // 4),
                            Lr - Lr // 4)
                d = t_new - int(trims[s])
                if d <= 0:
                    continue
                for g in range(ns):
                    streams[g][s] = streams[g][s][d * LANES:].clone()
                trims[s] = t_new
            _phase(f"trim {ri}", dev)
    return out


def sort_kv_chunked(key_segs, val_segs=None, *, tile_log2: int = 15,
                    chunk_log2: int = 19, nranges: int = 2,
                    blk: int = M.DEF_BLK, buf_elems: int = M.DEF_BUF,
                    ce: str = "reshape", pipeline="full",
                    interpret: bool | None = None,
                    range_consumer=None, fanout: int | None = None):
    """Stable kv sort of segment-chunked columns at chip scale.

    key_segs: list of S equal-length uint32 segments (S in 2..8); together
    they form the column keys = concat(key_segs). val_segs: optional
    matching uint32 payload segments. Both lists are emptied (see the
    module docstring). Returns (key_ranges, rank_ranges[, val_ranges]):
    `nranges` range-chunked tensors per stream, ranks the uint32 global
    positions. With range_consumer set, the ranges are released instead of
    returned (see merge_runs_chunked)."""
    segs = list(key_segs)
    vsegs = None if val_segs is None else list(val_segs)
    S = len(segs)
    L = segs[0].shape[0]
    if any(int(s.shape[0]) != L for s in segs):
        raise ValueError("segments must be equal length")
    key_segs.clear()
    if vsegs is not None:
        val_segs.clear()
    dev = segs[0].device
    runs_k, runs_r, runs_v = [], [], []
    for s in range(S):
        _debug(f"segment {s}/{S} sort")
        pos = i64_to_u32(torch.arange(s * L, (s + 1) * L, device=dev))
        ride = [] if vsegs is None else [vsegs[s]]
        k, vs = _merge_chain([segs[s], pos], ride, tile_log2)
        segs[s] = None
        if vsegs is not None:
            vsegs[s] = None
            runs_v.append(vs[1])
        runs_k.append(k)
        runs_r.append(vs[0])
        del k, vs, pos, ride
        _phase(f"segment {s}", dev)
    streams = [runs_k, runs_r] + ([runs_v] if vsegs is not None else [])
    del runs_k, runs_r, runs_v
    outs = merge_runs_chunked(streams, chunk_log2=chunk_log2,
                              nranges=nranges, blk=blk,
                              buf_elems=buf_elems, ce=ce,
                              pipeline=pipeline, interpret=interpret,
                              range_consumer=range_consumer,
                              consume_inputs=True, fanout=fanout)
    return tuple(outs)


def sort_with_ranks_chunked(key_segs, **kw):
    """sort_kv_chunked without a payload: (key_ranges, rank_ranges)."""
    return sort_kv_chunked(key_segs, None, **kw)
