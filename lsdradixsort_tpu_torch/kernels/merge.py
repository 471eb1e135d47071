"""8-way merge passes — the port of `merge_pass_multi` and its wrappers
`merge_pass` and `merge_pass_kv`, and of the chip-scale chunked pass
`merge_pass_runs` with its exact-rank tables `merge_tables_exact_runs`
(lsdradixsort_tpu/kernels/merge.py).

One `merge_pass_multi` pass turns every group of KWAY = 8 consecutive
sorted runs of `run_len` rows into one sorted run; n is any count, the
last run ending at n (the last group may hold fewer runs, and its last
run fewer rows). Rows are ordered by the key, then by payload 0 when
ncmp >= 2 (the default with payloads), then by payload 1 when ncmp = 3
(the 64-bit single-chain sort), all unsigned as in the TPU kernel
(merge.py:388-389); equal rows keep run order, then input order. Every
payload moves with its row.

`merge_pass_runs` merges S <= 8 sorted runs that each sit in a buffer of
their own (lengths may differ once consumed prefixes are trimmed) and
writes one range of whole chunks of the merged order, as
ops/bigsort.py's 2^30 memory plan needs. `merge_tables_exact_runs` is
torch glue, as it is jnp in the JAX package: the same k-way selection
(value bisection or `fanout` interval shrink) and the same int32 table,
bit for bit. The port's kernel reads only two things from the table: the
range's first rank and, per run, the union of the range's windows.

The TPU kernels needed sample tables from an XLA prepass
(`merge_pass_tables`), VMEM quarter buffers and DMA windows, and a skew
fallback for tables that overflow the buffer. On the card
(``csrc/merge.cu``, whose header gives the designs and what bounds
them) `merge_pass_multi` is a merge-path merge partitioned by output:
`merge_path_splits` finds, for every output tile of TILE rows of a
group, the exact co-rank of its first row in each run (the rows of that
run the merged order puts before it), and one CTA a tile merges its
windows, which together hold exactly TILE rows, in shared memory.
`merge_pass_runs` is the same merge over runs in separate buffers:
`merge_runs_splits` partitions its range of ranks into tiles the same
way, searching each run only within the range's table window, and the
same tile merge writes them. Neither has a capacity to overflow; the TPU knobs
(buf_elems, blk for the DMA windows, ce, pipeline, interpret) are
accepted and change nothing.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs the plain PyTorch version (a stable sort), which `chip_smoke.py`
also runs on the card to check the kernel. `LAUNCHES` and `PLAIN_CALLS`
count both.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.convert import (gather, row_order,
                                                 segment_orders,
                                                 sort_segments)
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

KWAY = 8              # fan-in per merge pass
MAX_STREAMS = 8       # key + payloads the kernel moves in one pass
TILE = 1 << 12        # output rows a merge CTA writes (kTile, csrc/merge.cu)
LANES = 128           # the table counts rows in units of 128
NCOLS = 24            # columns of a merge table (the JAX layout)
# Defaults of the JAX merge engine's TPU tuning knobs (sample stride and
# VMEM buffer, in elements). ops/sort.py accepts and ignores those knobs.
DEF_BLK = 2048
DEF_BUF = 1 << 20

_NAMES = ("merge_path_splits", "merge_pass_multi", "merge_pass_runs")
LAUNCHES = dict.fromkeys(_NAMES, 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)
_SIGN32 = -(1 << 31)  # 0x80000000 as an int32 bit pattern


def _check(keys: torch.Tensor, vals, run_len: int, ncmp) -> int:
    """Validate the inputs; return ncmp."""
    n = keys.shape[0]
    if run_len < 1:
        raise ValueError(f"run_len={run_len} must be positive")
    if 1 + len(vals) > MAX_STREAMS:
        raise ValueError(f"at most {MAX_STREAMS - 1} payload streams, got "
                         f"{len(vals)}")
    for s in (keys, *vals):
        if s.dtype != torch.uint32 or s.dim() != 1 or s.shape[0] != n:
            raise ValueError("streams must be (n,) torch.uint32, got "
                             f"{s.dtype} {tuple(s.shape)}")
        if not s.is_contiguous() or s.device != keys.device:
            raise ValueError("streams must be contiguous, on one device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if ncmp is None:
        ncmp = min(2, 1 + len(vals))
    if ncmp not in (1, 2, 3) or ncmp > 1 + len(vals):
        raise ValueError(f"ncmp={ncmp} with {len(vals)} payloads")
    return ncmp


def tile_plan(n: int, run_len: int) -> tuple[int, int]:
    """(tiles of the first group, tiles in all) of a merge pass's output:
    each group of up to KWAY runs (the last ending at n) in tiles of TILE
    rows, the last short. Tile t of the pass is tile t % tiles_per_group
    of group t // tiles_per_group (the last group may hold fewer)."""
    if n == 0:
        return 1, 0
    group = KWAY * run_len
    groups = -(-n // group)
    last = n - (groups - 1) * group
    return -(-min(n, group) // TILE), (groups - 1) * -(-group // TILE) + -(
        -last // TILE)


def merge_path_splits_plain(keys, vals, run_len: int,
                            ncmp: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the merge-path partition: the co-ranks of
    every output tile's first row, read off a stable sort of each group
    (the source run of each merged row, counted tile by tile)."""
    vals = list(vals)
    ncmp = _check(keys, vals, run_len, ncmp)
    PLAIN_CALLS["merge_path_splits"] += 1
    parts = []
    # full groups, then the rest
    for _, _, perm in segment_orders([keys, *vals][:ncmp], KWAY * run_len):
        width = perm.shape[1]
        tiles = -(-width // TILE)
        run = torch.nn.functional.pad(perm // run_len,
                                      (0, tiles * TILE - width), value=KWAY)
        cell = (torch.arange(perm.shape[0] * tiles, device=keys.device)
                .view(-1, tiles, 1) * (KWAY + 1)
                + run.view(-1, tiles, TILE))
        counts = torch.bincount(cell.view(-1),
                                minlength=cell.shape[0] * tiles
                                * (KWAY + 1)).view(-1, tiles, KWAY + 1)
        counts = counts[..., :KWAY]
        parts.append((counts.cumsum(1) - counts).view(-1, KWAY))
    if not parts:
        return torch.zeros((0, KWAY), dtype=torch.int32, device=keys.device)
    return torch.cat(parts).to(torch.int32)


def merge_path_splits(keys: torch.Tensor, vals, run_len: int,
                      ncmp: int | None = None) -> torch.Tensor:
    """The merge-path partition of one merge pass: a (tiles, KWAY) int32
    table (`tile_plan`), row t the number of rows of each run of tile t's
    group that the merged order (the compared words unsigned, then run,
    then position) puts before the tile's first row; 0 for runs past the
    group's last. Only the first ncmp streams are read."""
    vals = list(vals)
    if keys.device.type == "cpu":
        return merge_path_splits_plain(keys, vals, run_len, ncmp)
    ncmp = _check(keys, vals, run_len, ncmp)
    n = keys.shape[0]
    out = torch.empty((tile_plan(n, run_len)[1], KWAY), dtype=torch.int32,
                      device=keys.device)
    with annotate("lsd.kernel.merge_path_splits"), \
            torch.cuda.device(keys.device):
        if _build.library().lsd_merge_tile() != TILE:
            raise RuntimeError("csrc/merge.cu kTile differs from TILE")
        fn = _build.function("lsd_merge_path_splits", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        _build.check(fn(_build.pointers([keys, *vals][:ncmp]), n, run_len,
                        ncmp, out.data_ptr(), ctypes.c_void_p(stream)),
                     "lsd_merge_path_splits")
    LAUNCHES["merge_path_splits"] += 1
    return out


def merge_pass_multi_plain(keys, vals, run_len: int,
                           ncmp: int | None = None, *,
                           buf_elems: int | None = None, blk: int = DEF_BLK,
                           interpret: bool | None = None, ce: str = "roll",
                           pipeline: bool = True):
    """Plain PyTorch version: a stable sort of each group of KWAY runs by
    the compared streams."""
    vals = list(vals)
    ncmp = _check(keys, vals, run_len, ncmp)
    PLAIN_CALLS["merge_pass_multi"] += 1
    out = sort_segments([keys, *vals][:ncmp], vals[ncmp - 1:], KWAY * run_len)
    return out[0], out[1:]


def merge_pass_multi(keys: torch.Tensor, vals, run_len: int,
                     ncmp: int | None = None, *, buf_elems: int | None = None,
                     blk: int = DEF_BLK, interpret: bool | None = None,
                     ce: str = "roll", pipeline: bool = True):
    """One KWAY merge pass with any number of payload streams (up to 7).

    keys and vals: (n,) uint32, sorted in runs of run_len by the compared
    streams (the key, then vals[0] when ncmp >= 2, then vals[1] when
    ncmp = 3), the last run ending at n.
    Returns (sorted_keys, [payloads...]) in runs of KWAY * run_len."""
    vals = list(vals)
    if keys.device.type == "cpu":
        return merge_pass_multi_plain(keys, vals, run_len, ncmp)
    ncmp = _check(keys, vals, run_len, ncmp)
    streams = [keys, *vals]
    with annotate("lsd.kernel.merge_pass_multi"):
        splits = merge_path_splits(keys, vals, run_len, ncmp)
        outs = [torch.empty_like(s) for s in streams]
        with torch.cuda.device(keys.device):
            fn = _build.function("lsd_merge_pass", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            _build.check(fn(_build.pointers(streams), _build.pointers(outs),
                            len(streams), keys.shape[0], run_len, ncmp,
                            splits.data_ptr(), ctypes.c_void_p(stream)),
                         "lsd_merge_pass")
    LAUNCHES["merge_pass_multi"] += 1
    return outs[0], outs[1:]


def merge_pass_kv(keys: torch.Tensor, vals: torch.Tensor, run_len: int, *,
                  buf_elems: int | None = None, blk: int = DEF_BLK,
                  interpret: bool | None = None, ce: str = "roll",
                  pipeline: bool = True):
    """One merge pass carrying one payload, which breaks ties: a stable key
    merge when vals are unique and follow run order (e.g. row ids)."""
    ok, (ov,) = merge_pass_multi(keys, [vals], run_len)
    return ok, ov


def merge_pass(keys: torch.Tensor, run_len: int, *,
               buf_elems: int | None = None, blk: int = DEF_BLK,
               interpret: bool | None = None, ce: str = "roll",
               pipeline: bool = True) -> torch.Tensor:
    """One keys-only merge pass: sorted runs of run_len -> KWAY*run_len."""
    out, _ = merge_pass_multi(keys, [], run_len)
    return out


# ---------------------------------------------------------------------------
# Chip-scale chunked pass: runs in separate buffers, exact-rank chunks
# ---------------------------------------------------------------------------

def merge_tables_exact_runs(run_keys, chunk_elems: int, blk: int = DEF_BLK,
                            fanout: int | None = None,
                            rounds: int | None = None):
    """Exact-rank merge tables for S separately buffered sorted runs: every
    chunk is exactly chunk_elems rows; boundary t sits at global rank
    t * chunk_elems of the (key, run, position) order, found by k-way
    selection (the key of that rank by value search, then ties filled in
    run order).

    fanout=None is a 32-round value bisection; an integer fanout >= 3
    probes fanout - 1 candidates per boundary per round (the interval
    shrink of the JAX package's distributed splitter search); rounds
    overrides its derived round count.

    run_keys: list of S (L,) uint32 sorted tensors, S <= KWAY, equal L.
    Returns (tab, max_pair) as the JAX package does: tab is
    ((nch + pad + 8), NCOLS) int32, col s the window start of run s in
    128-row units, cols 8-15 the window lengths in blk units, col 16 m,
    col 17 the emit row, col 18 the absolute out row, col 19 C / 128;
    max_pair the largest wblk[2q] + wblk[2q+1] (the TPU kernel's quarter
    load, which nothing in the port checks).

    Values are searched as int64 in [0, 2^32) and the runs as int32 views
    with the sign bit flipped (whose signed order is the unsigned order):
    CPU torch has no uint32 compares, CUDA torch no uint32 searchsorted.
    """
    S = len(run_keys)
    L = run_keys[0].shape[0]
    C = chunk_elems
    nch = S * L // C
    dev = run_keys[0].device
    runs = [k.view(torch.int32) ^ _SIGN32 for k in run_keys]

    def count(v, right=True):
        """Per run, its rows ordered at or before (right) or before v."""
        probe = (v - (1 << 31)).to(torch.int32)
        return [torch.searchsorted(r, probe, right=right) for r in runs]

    g = torch.arange(1, nch, dtype=torch.int64, device=dev) * C
    vlo = torch.zeros_like(g)
    vhi = torch.full_like(g, 0xFFFFFFFF)
    if fanout is None:
        for _ in range(32):
            live = vlo < vhi
            mid = vlo + ((vhi - vlo) >> 1)
            pred = sum(count(mid)) >= g + 1
            vhi = torch.where(live & pred, mid, vhi)
            vlo = torch.where(live & ~pred, mid + 1, vlo)
    else:
        F = fanout
        if F < 3:
            raise ValueError(f"fanout={F} must be >= 3")
        if rounds is None:
            # width recurrence: w' <= w // (F-1) + (F-3); any w <= F-1
            # collapses to 0 in one round (consecutive unit-step probes)
            w, rounds = 1 << 32, 0
            while w > 0:
                w = w // (F - 1) + (F - 3) if w > F - 1 else 0
                rounds += 1
        jj = torch.arange(F - 1, dtype=torch.int64, device=dev)[None, :]
        for _ in range(rounds):
            w = vhi - vlo
            step = torch.clamp(w // (F - 1), min=1)
            probes = vlo[:, None] + torch.minimum(step[:, None] * jj,
                                                  w[:, None])
            geq = sum(count(probes)) >= (g + 1)[:, None]      # monotone
            any_ = geq.any(dim=1)
            first = geq.to(torch.int32).argmax(dim=1)         # 0 if none
            pf = probes.gather(1, first[:, None].long())[:, 0]
            pprev = probes.gather(
                1, (first - 1).clamp(min=0)[:, None].long())[:, 0]
            vhi, vlo = (torch.where(any_, pf, vhi),
                        torch.where(any_, torch.where(first > 0, pprev + 1,
                                                      vlo),
                                    probes[:, -1] + 1))
    lo = torch.stack(count(vlo, right=False), dim=1)           # (nch-1, S)
    eq = torch.stack(count(vlo), dim=1) - lo
    del runs
    need = g - lo.sum(dim=1)                                   # == vstar
    cum = eq.cumsum(dim=1) - eq                                # run by run
    take = torch.minimum(torch.clamp(need[:, None] - cum, min=0), eq)
    rank = torch.cat([torch.zeros((1, S), dtype=torch.int64, device=dev),
                      lo + take,
                      torch.full((1, S), L, dtype=torch.int64, device=dev)])

    # block-aligned windows + exact in-buffer offsets
    wstart = rank[:nch] // blk
    wend = torch.maximum((rank[1:] + blk - 1) // blk, wstart)
    wblk = wend - wstart                                       # (nch, S)
    pre = (rank[:nch] - wstart * blk).sum(dim=1)               # exact
    if S < KWAY:
        z = torch.zeros((nch, KWAY - S), dtype=torch.int64, device=dev)
        wstart = torch.cat([wstart, z], dim=1)
        wblk = torch.cat([wblk, z], dim=1)
    max_pair = (wblk[:, 0::2] + wblk[:, 1::2]).max().to(torch.int32)
    m = (-pre) % LANES
    tab = torch.zeros((-(-nch // 8) * 8 + 8, NCOLS), dtype=torch.int64,
                      device=dev)
    tab[:nch, 0:KWAY] = wstart * (blk // LANES)
    tab[:nch, KWAY:2 * KWAY] = wblk
    tab[:nch, 16] = m
    tab[:nch, 17] = (pre + m) // LANES
    tab[:nch, 18] = torch.arange(nch, device=dev) * (C // LANES)
    tab[:nch, 19] = C // LANES
    return tab.to(torch.int32), max_pair


def window_table(first, end, lo_rank: int,
                 blk: int = DEF_BLK) -> torch.Tensor:
    """A table in `merge_tables_exact_runs`' layout for one range (chunk
    0) of `merge_pass_runs`: run s seen through rows [first[s], end[s])
    (first[s] a multiple of LANES), the range's first rank lo_rank. Any
    windows hold a range whose rows they cover and whose rows before
    (after) them rank before (after) it: whole runs always do."""
    S = len(first)
    if any(f % LANES for f in first):
        raise ValueError(f"window starts must be multiples of {LANES}")
    tab = torch.zeros((16, NCOLS), dtype=torch.int64)
    tab[0, :S] = torch.tensor(first) // LANES
    tab[0, KWAY:KWAY + S] = -(-(torch.tensor(end) - torch.tensor(first))
                              // blk)
    pre = lo_rank - sum(first)
    m = (-pre) % LANES
    tab[0, 16] = m
    tab[0, 17] = (pre + m) // LANES
    return tab.to(torch.int32)


def _runs_plan(run_streams, tables, chunk0: int, nchunks: int,
               chunk_elems: int, blk: int, ncmp):
    """Validate a merge_pass_runs call; return (ncmp, lens, first, end,
    lo_rank, count): rows [first[s], end[s]) of run s hold every row of
    the range (the union of its table windows), whose first merged rank
    in these buffers is lo_rank."""
    ns = len(run_streams)
    S = len(run_streams[0]) if ns else 0
    if not 1 <= ns <= MAX_STREAMS or not 1 <= S <= KWAY:
        raise ValueError(f"need 1..{MAX_STREAMS} streams of 1..{KWAY} runs, "
                         f"got {ns} streams of {S}")
    dev = run_streams[0][0].device
    lens = [int(r.shape[0]) for r in run_streams[0]]
    for rs in run_streams:
        if len(rs) != S:
            raise ValueError("every stream needs one buffer per run")
        for r, ln in zip(rs, lens):
            if r.dtype != torch.uint32 or r.dim() != 1 or r.shape[0] != ln:
                raise ValueError("run buffers must be (L_s,) torch.uint32, "
                                 "equal in length across streams, got "
                                 f"{r.dtype} {tuple(r.shape)}")
            if not r.is_contiguous() or r.device != dev:
                raise ValueError("run buffers must be contiguous, on one "
                                 "device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if ncmp is None:
        ncmp = min(2, ns)
    if ncmp not in (1, 2, 3) or ncmp > ns:
        raise ValueError(f"ncmp={ncmp} with {ns} streams")
    tab = torch.as_tensor(tables).to("cpu", torch.int64)
    if chunk0 < 0 or nchunks < 1 or chunk0 + nchunks > tab.shape[0]:
        raise ValueError(f"chunks [{chunk0}, {chunk0 + nchunks}) outside a "
                         f"table of {tab.shape[0]} rows")
    rows = tab[chunk0:chunk0 + nchunks]
    start = rows[:, :S] * LANES
    stop = start + rows[:, KWAY:KWAY + S] * blk
    first = [min(max(int(start[:, s].min()), 0), lens[s]) for s in range(S)]
    end = [min(max(int(stop[:, s].max()), first[s]), lens[s])
           for s in range(S)]
    lo_rank = (int(rows[0, :KWAY].sum()) * LANES + int(rows[0, 17]) * LANES
               - int(rows[0, 16]))
    count = nchunks * chunk_elems
    if lo_rank < 0 or lo_rank + count > sum(lens):
        raise ValueError(f"ranks [{lo_rank}, {lo_rank + count}) outside the "
                         f"{sum(lens)} rows of the runs")
    return ncmp, lens, first, end, lo_rank, count


def _candidates(run_streams, first, end):
    """Each stream's rows [first[s], end[s]) of every run s, run by run."""
    return [torch.cat([r.view(torch.int32)[a:b]
                       for r, a, b in zip(rs, first, end)]).view(torch.uint32)
            for rs in run_streams]


def merge_runs_splits_plain(run_streams, tables, *, chunk0: int,
                            nchunks: int, chunk_elems: int,
                            blk: int = DEF_BLK, ncmp: int | None = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the partition of one range of
    `merge_pass_runs` into output tiles: a (tiles + 1, KWAY) int32 table
    (tiles = ceil(count / TILE)), row i the number of rows of each run
    that the merged order puts before rank lo_rank + min(i * TILE,
    count); 0 for runs past the last. Read off a stable sort of the rows
    the range's windows cover (every row of a run before its window ranks
    before the range): the source run of each merged row, counted tile by
    tile."""
    ncmp, lens, first, end, lo_rank, count = _runs_plan(
        run_streams, tables, chunk0, nchunks, chunk_elems, blk, ncmp)
    PLAIN_CALLS["merge_path_splits"] += 1
    S = len(lens)
    dev = run_streams[0][0].device
    cand = _candidates(run_streams[:ncmp], first, end)
    perm = row_order(cand, cand[0].shape[0]).view(-1)
    src = torch.repeat_interleave(
        torch.arange(S, device=dev),
        torch.tensor([b - a for a, b in zip(first, end)], device=dev))[perm]
    at = lo_rank - sum(first)
    edges = at + torch.clamp(torch.arange(-(-count // TILE) + 1, device=dev)
                             * TILE, max=count)
    out = torch.zeros((edges.shape[0], KWAY), dtype=torch.int64, device=dev)
    for s in range(S):
        # run s's rows among the first `edge` merged candidates
        out[:, s] = first[s] + torch.searchsorted(
            (src == s).nonzero().view(-1), edges)
    return out.to(torch.int32)


def merge_runs_splits(run_streams, tables, *, chunk0: int, nchunks: int,
                      chunk_elems: int, blk: int = DEF_BLK,
                      ncmp: int | None = None) -> torch.Tensor:
    """The merge-path partition of one range of `merge_pass_runs` (the
    table of `merge_runs_splits_plain`), launched on the card by the same
    kernel as `merge_path_splits` and counted under its name."""
    ncmp, lens, first, end, lo_rank, count = _runs_plan(
        run_streams, tables, chunk0, nchunks, chunk_elems, blk, ncmp)
    key = run_streams[0][0]
    if key.device.type == "cpu":
        return merge_runs_splits_plain(
            run_streams, tables, chunk0=chunk0, nchunks=nchunks,
            chunk_elems=chunk_elems, blk=blk, ncmp=ncmp)
    S = len(lens)
    out = torch.empty((-(-count // TILE) + 1, KWAY), dtype=torch.int32,
                      device=key.device)
    ins = [run_streams[t][s] for s in range(S) for t in range(ncmp)]
    rows = ctypes.c_longlong * S
    with annotate("lsd.kernel.merge_runs_splits"), \
            torch.cuda.device(key.device):
        if _build.library().lsd_merge_tile() != TILE:
            raise RuntimeError("csrc/merge.cu kTile differs from TILE")
        fn = _build.function("lsd_merge_runs_splits", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p])
        stream = torch.cuda.current_stream(key.device).cuda_stream
        _build.check(fn(_build.pointers(ins), S, ncmp, rows(*lens),
                        rows(*first), rows(*end), lo_rank, count, ncmp,
                        out.data_ptr(), ctypes.c_void_p(stream)),
                     "lsd_merge_runs_splits")
    LAUNCHES["merge_path_splits"] += 1
    return out


def merge_pass_runs_plain(run_streams, tables, *, chunk0: int, nchunks: int,
                          chunk_elems: int, buf_elems: int,
                          blk: int = DEF_BLK, interpret: bool | None = None,
                          ce: str = "roll", pipeline: bool = True,
                          ncmp: int | None = None):
    """Plain PyTorch version: a stable sort of the rows the range's
    windows cover, run by run, and the range's slice of it (every row of
    a run before its window ranks before the range, every row after it
    after the range)."""
    ncmp, _, first, end, lo_rank, count = _runs_plan(
        run_streams, tables, chunk0, nchunks, chunk_elems, blk, ncmp)
    PLAIN_CALLS["merge_pass_runs"] += 1
    cand = _candidates(run_streams, first, end)
    perm = row_order(cand[:ncmp], cand[0].shape[0]).view(-1)
    at = lo_rank - sum(first)
    perm = perm[at:at + count]
    return [gather(c, perm) for c in cand]


def merge_pass_runs(run_streams, tables, *, chunk0: int, nchunks: int,
                    chunk_elems: int, buf_elems: int, blk: int = DEF_BLK,
                    interpret: bool | None = None, ce: str = "roll",
                    pipeline: bool = True, ncmp: int | None = None):
    """One chunk range of a merge whose S input runs live in separate
    buffers (ops/bigsort.py).

    run_streams: list over ns streams (the key, val0, riders) of lists
    over S runs of (L_s,) uint32 tensors; lengths may differ across runs
    (trimmed prefixes), not across the streams of one run. tables: from
    `merge_tables_exact_runs`, window starts already reduced by any trim.
    Returns ns fresh (nchunks * chunk_elems,) uint32 tensors: the rows of
    merged ranks [start(chunk0), start(chunk0) + nchunks * chunk_elems)
    of these buffers, ordered by the first ncmp (default min(2, ns))
    streams unsigned, then run, then position. No capacity: any key
    distribution goes through the kernel: the range's partition into
    output tiles (`merge_runs_splits`), then one CTA a tile."""
    ncmp, lens, first, end, lo_rank, count = _runs_plan(
        run_streams, tables, chunk0, nchunks, chunk_elems, blk, ncmp)
    key = run_streams[0][0]
    kw = dict(chunk0=chunk0, nchunks=nchunks, chunk_elems=chunk_elems,
              blk=blk, ncmp=ncmp)
    if key.device.type == "cpu":
        return merge_pass_runs_plain(run_streams, tables, buf_elems=buf_elems,
                                     **kw)
    S, ns = len(lens), len(run_streams)
    ins = [run_streams[t][s] for s in range(S) for t in range(ns)]
    rows = ctypes.c_longlong * S
    with annotate("lsd.kernel.merge_pass_runs"):
        splits = merge_runs_splits(run_streams, tables, **kw)
        outs = [torch.empty(count, dtype=torch.uint32, device=key.device)
                for _ in range(ns)]
        with torch.cuda.device(key.device):
            fn = _build.function("lsd_merge_pass_runs", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])
            stream = torch.cuda.current_stream(key.device).cuda_stream
            _build.check(fn(_build.pointers(ins), _build.pointers(outs), S,
                            ns, rows(*lens), rows(*first), rows(*end),
                            lo_rank, count, ncmp, splits.data_ptr(),
                            ctypes.c_void_p(stream)),
                         "lsd_merge_pass_runs")
    LAUNCHES["merge_pass_runs"] += 1
    return outs
