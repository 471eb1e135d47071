"""Per-tile sort — the port of lsdradixsort_tpu/kernels/tile_sort.py.

Every tile of ``tile_rows * 128`` rows is sorted ascending; n is any
count, the last tile ending at n (it may be short, where the JAX kernels
need whole tiles):

  * `sort_tiles`: keys only (replaces `_bitonic_keys_kernel`).
  * `sort_tiles_kv`: by (key, val), val compared as a SIGNED int32 — the
    JAX kernel casts val to int32 with no bias (tile_sort.py:207). The
    quirk only matters for tied keys with vals >= 2^31 and is kept so the
    port is bit exact (replaces `_bitonic_kernel`).
  * `sort_tiles_multi`: by the key and the first ncmp-1 payloads
    (ncmp = 1, 2 or 3; 3 is the 64-bit (hi, lo, position) sort), compared
    unsigned; the other payloads ride (replaces `_bitonic_multi_kernel`).
    The TPU network leaves the order of rows tied on the compared words
    to the network; the port sorts riders stably (by their row index),
    which is one of those orders.

On a CUDA tensor each wrapper launches a hand-written kernel in
``csrc/tile_sort.cu`` (its header says what bounds it on the H100 and how
the design copes): a bitonic network for every word count, or, for the
rider path (key, payload 0 and the index word at the 2^15-row tile), a
stable merge sort (`design` picks it from the words). On a CPU tensor it
runs the plain PyTorch version beside them, which `chip_smoke.py` also
runs on the card to check the kernels. `LAUNCHES` counts kernel launches
per wrapper, `DESIGN_CALLS` tile-sort calls by design, and `PLAIN_CALLS`
runs of the plain versions. `interpret` and `ce` are the TPU's lowering
knobs, in the JAX package's argument order: accepted and ignored.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lsdradixsort_tpu_torch.core.convert import sort_segments
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
_SIGN = 1 << 31

LAUNCHES = {"sort_tiles": 0, "sort_tiles_kv": 0, "sort_tiles_multi": 0}
PLAIN_CALLS = {"sort_tiles": 0, "sort_tiles_kv": 0, "sort_tiles_multi": 0}


def _check_tiles(keys: torch.Tensor, streams, tile_rows: int) -> int:
    """Validate the inputs; return log2 of the tile."""
    if tile_rows < 1 or tile_rows & (tile_rows - 1):
        raise ValueError(f"tile_rows={tile_rows} must be a power of 2")
    tile = tile_rows * LANES
    n = keys.shape[0]
    for s in (keys, *streams):
        if s.dtype != torch.uint32 or s.dim() != 1 or s.shape[0] != n:
            raise ValueError("streams must be (n,) torch.uint32, got "
                             f"{s.dtype} {tuple(s.shape)}")
        if not s.is_contiguous() or s.device != keys.device:
            raise ValueError("streams must be contiguous, on one device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return tile.bit_length() - 1


def _ncmp(values, ncmp) -> int:
    if ncmp is None:
        ncmp = 2 if values else 1
    if ncmp not in (1, 2, 3) or ncmp - 1 > len(values):
        raise ValueError(f"ncmp={ncmp} with {len(values)} payloads")
    return ncmp


# --- plain PyTorch versions -------------------------------------------------

def _sort_tiles_plain(words, riders, tile: int, flip1: bool = False):
    return sort_segments(words, riders, tile, flip1)


def sort_tiles_plain(keys, tile_rows: int = 128,
                     interpret: bool | None = None, ce: str = "roll"):
    _check_tiles(keys, (), tile_rows)
    PLAIN_CALLS["sort_tiles"] += 1
    return _sort_tiles_plain([keys], [], tile_rows * LANES)[0]


def sort_tiles_kv_plain(keys, values, tile_rows: int = 128,
                        interpret: bool | None = None, ce: str = "roll"):
    _check_tiles(keys, (values,), tile_rows)
    PLAIN_CALLS["sort_tiles_kv"] += 1
    return tuple(_sort_tiles_plain([keys, values], [], tile_rows * LANES,
                                   flip1=True))


def sort_tiles_multi_plain(keys, values, tile_rows: int = 128,
                           interpret: bool | None = None, ce: str = "roll",
                           ncmp: int | None = None):
    values = list(values)
    _check_tiles(keys, values, tile_rows)
    ncmp = _ncmp(values, ncmp)
    PLAIN_CALLS["sort_tiles_multi"] += 1
    out = _sort_tiles_plain([keys, *values[:ncmp - 1]], values[ncmp - 1:],
                            tile_rows * LANES)
    return out[0], out[1:]


# --- CUDA kernels -----------------------------------------------------------

# cluster_sort's geometry a word count (1..4): log2 of the most rows a CTA
# holds (all its words in shared memory: 128, 128, 192 and 128 KB), log2 of
# the rows E a thread holds in registers, and the threads of a full CTA
# (512, so up to 128 registers a thread); a thread takes its CTA's rows E
# at a time, 2^rows / (E * threads) groups a step.
GEOMETRY = {1: (15, 6, 512), 2: (14, 5, 512), 3: (14, 4, 512),
            4: (13, 4, 512)}
MAX_CLUSTER = 4
SMEM_LIMIT = 232_448      # bytes of shared memory a block may use
MAX_RIDERS = 16           # riders one launch gathers (csrc kMaxRiders)
MAX_STEPS = 64            # steps of one cluster launch (csrc kMaxSteps)
STAGE, FIRST, GROUP = 0, 1, 2
# lsd_sort_tiles(words, dst, nwords, n, tile_log2, flip1, cluster,
# rows_log2, group_log2, code, ncode, riders, rider_dst, nriders, stream)
SORT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p]

# CUDA kernel launches of the tile sorts, by kernel (a wrapper call counts
# one in LAUNCHES and its kernels' launches here; both designs launch a
# kernel named cluster_sort)
KERNEL_LAUNCHES = {"bitonic_stage": 0, "cluster_sort": 0}
# tile-sort calls on the card, by the design that sorted them (`design`)
DESIGN_CALLS = {"network": 0, "merge": 0}

# The merge design (csrc/tile_sort.cu tile_merge::cluster_sort): its tile,
# clusters of MERGE_CLUSTER CTAs of 2^MERGE_ROWS_LOG2 rows, 2^MERGE_G rows
# a thread (the CTA's threads: 2^(rows - G)); csrc kG, kRowsLog2, kCluster
MERGE_TILE_LOG2 = 15
MERGE_CLUSTER, MERGE_ROWS_LOG2, MERGE_G = 4, 13, 4
# lsd_sort_tiles_merge(key, val, key_out, val_out, n, riders, rider_dst,
# nriders, stream)
MERGE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p]


class Step(NamedTuple):
    """One step of a tile sort's schedule.

    STAGE: the device-memory stage (kl, jl = jx), one pass over the words.
    FIRST: phases 1..kl in registers, each thread on E consecutive rows,
    straight from the load. GROUP: the cross-CTA stage (kl, jx) if jx >= 0,
    then the stages jhi..jlo of phase kl (if jhi >= 0) in registers, each
    thread on the E rows that differ only in bits b..b+G-1."""
    kind: int
    kl: int
    jx: int = -1
    jhi: int = -1
    jlo: int = -1
    b: int = 0

    @property
    def code(self) -> int:
        """The int32 csrc/tile_sort.cu `decode` reads."""
        return (self.kind | self.kl << 2 | (self.jx + 1) << 7
                | (self.jhi + 1) << 12 | (self.jlo + 1) << 17 | self.b << 22)

    def stages(self) -> list[tuple[int, int]]:
        """The (kl, jl) stages of the network this step runs, in order."""
        if self.kind == STAGE:
            return [(self.kl, self.jx)]
        if self.kind == FIRST:
            return [(k, j) for k in range(1, self.kl + 1)
                    for j in range(k - 1, -1, -1)]
        out = [(self.kl, self.jx)] if self.jx >= 0 else []
        if self.jhi >= 0:
            out += [(self.kl, j) for j in range(self.jhi, self.jlo - 1, -1)]
        return out


class TilePlan(NamedTuple):
    """How csrc/tile_sort.cu `cluster_sort` sorts tiles of `nwords` words:
    clusters of `cluster` CTAs of 2^rows_log2 rows (span 2^span_log2 rows),
    `threads` a CTA, E = 2^group_log2 rows a thread, `smem_bytes` of
    shared memory a CTA, and the schedule `steps`."""
    nwords: int
    tile_log2: int
    cluster: int
    rows_log2: int
    group_log2: int
    threads: int
    smem_bytes: int
    span_log2: int
    steps: tuple

    def launches(self) -> dict:
        """Kernel launches of one call: a cluster_sort a run of steps
        between device-memory stages, a bitonic_stage each of those."""
        stages = sum(s.kind == STAGE for s in self.steps)
        runs = sum(s.kind != STAGE and (i == 0 or self.steps[i - 1].kind
                                         == STAGE)
                   for i, s in enumerate(self.steps))
        return {"bitonic_stage": stages, "cluster_sort": runs}


def _schedule(t: int, r: int, s: int, g: int) -> list[Step]:
    """The steps of a tile of 2^t rows: clusters of span 2^s rows, CTAs of
    2^r rows, register groups of 2^g rows."""
    steps = []

    def cluster_run(k_begin, k_end):
        kl = k_begin
        if kl == 1:
            steps.append(Step(FIRST, min(g, k_end)))
            kl = min(g, k_end) + 1
        for kl in range(kl, k_end + 1):
            j = min(kl, s) - 1
            while j >= 0:
                jx = -1
                if j >= r:                 # a cross-CTA stage
                    if j - 1 >= r:         # another follows: on its own,
                        # over the CTA's top bits so that a warp reads 32
                        # neighbouring rows of the partner
                        steps.append(Step(GROUP, kl, jx=j, b=r - g))
                        j -= 1
                        continue
                    jx, j = j, j - 1       # joins the first register group
                lo = max(j - g + 1, 0)
                steps.append(Step(GROUP, kl, jx, j, lo, lo))
                j = lo - 1

    cluster_run(1, min(t, s))
    for kl in range(s + 1, t + 1):
        steps += [Step(STAGE, kl, jl) for jl in range(kl - 1, s - 1, -1)]
        cluster_run(kl, kl)
    return steps


def tile_plan(nwords: int, tile_log2: int, n: int = 0) -> TilePlan:
    """The launch plan of `cluster_sort` for tiles of 2^tile_log2 rows of
    `nwords` (1..4) words over n rows (0: one tile). A tile above a CTA's
    rows takes a cluster of up to MAX_CLUSTER CTAs; a smaller one shares a
    CTA with its neighbours as far as the count of tiles (the short last
    one included) allows."""
    if nwords not in GEOMETRY:
        raise ValueError(f"cluster_sort sorts 1..4 words, not {nwords}")
    rmax, g, threads = GEOMETRY[nwords]
    if tile_log2 <= rmax:
        cluster = 1
        rows = -(-n >> tile_log2) << tile_log2     # whole tiles
        low = (rows & -rows).bit_length() - 1 if rows else tile_log2
        rows_log2 = min(rmax, max(low, tile_log2))
    else:
        cluster = min(MAX_CLUSTER, 1 << (tile_log2 - rmax))
        rows_log2 = rmax
    if rows_log2 < g:
        raise ValueError(f"tiles of 2^{tile_log2} rows: fewer than 2^{g} "
                         "rows a CTA")
    span = rows_log2 + cluster.bit_length() - 1
    return TilePlan(nwords, tile_log2, cluster, rows_log2, g,
                    min(threads, 1 << (rows_log2 - g)), 4 * nwords << rmax,
                    span,
                    tuple(_schedule(tile_log2, rows_log2, span, g)))


def design(words, tile_log2: int) -> str:
    """Which design of csrc/tile_sort.cu sorts these words: "merge"
    (tile_merge::cluster_sort) for (key, payload 0, index word) at the
    2^15-row tile, the rider path of `sort_tiles_multi` at ncmp = 2;
    "network" (the bitonic cluster_sort) for every other word count and
    tile."""
    merge = (len(words) == 3 and words[-1] is None
             and tile_log2 == MERGE_TILE_LOG2)
    return "merge" if merge else "network"


def _stream(key: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(key.device).cuda_stream)


def _launch_network(words, dst, riders, outs, plan: TilePlan,
                    flip1: bool) -> None:
    key = words[0]
    with torch.cuda.device(key.device):
        sort = _build.function("lsd_sort_tiles", SORT_ARGTYPES)
        code = (ctypes.c_int * len(plan.steps))(*[s.code for s in plan.steps])
        _build.check(sort(
            _build.pointers(words), _build.pointers(dst), len(words),
            key.shape[0], plan.tile_log2, _SIGN if flip1 else 0,
            plan.cluster, plan.rows_log2, plan.group_log2, code, len(code),
            _build.pointers(riders), _build.pointers(outs), len(riders),
            _stream(key)), "lsd_sort_tiles")


def _launch_merge(words, dst, riders, outs) -> None:
    key, val = words[0], words[1]
    with torch.cuda.device(key.device):
        sort = _build.function("lsd_sort_tiles_merge", MERGE_ARGTYPES)
        _build.check(sort(
            key.data_ptr(), val.data_ptr(),
            None if dst[0] is None else dst[0].data_ptr(),
            None if dst[1] is None else dst[1].data_ptr(), key.shape[0],
            _build.pointers(riders), _build.pointers(outs), len(riders),
            _stream(key)), "lsd_sort_tiles_merge")


def _sort_words(words, riders, tile_log2: int, flip1: bool):
    """Sort the tiles of `words` (u32 streams, the key first; None for the
    row-index word, last, when riders ride) with csrc/tile_sort.cu
    `cluster_sort` of the design `design` picks, which gathers the riders
    by the index word. Returns the sorted words (index word dropped) and
    riders."""
    key = words[0]
    n, tile = key.shape[0], 1 << tile_log2
    which = design(words, tile_log2)
    DESIGN_CALLS[which] += 1
    if which == "merge":
        return _run(words, riders, which, None, flip1, False)
    plan = tile_plan(len(words), tile_log2, n)
    # the index word reaches device memory only for the stages above
    # the cluster's span
    stored = any(s.kind == STAGE for s in plan.steps)
    if not stored or n % tile == 0:
        return _run(words, riders, which, plan, flip1, stored)
    # device-memory stages keep every row of a tile in device memory: the
    # whole tiles sort in place, the short last tile through one tile of
    # scratch whose missing rows hold all-ones words (word 1 all ones after
    # the flip1 XOR) and the tile's largest indices, so they sort last
    full = n - n % tile

    def scratch(s, fill):
        pad = torch.full((tile - (n - full),), fill, dtype=torch.int32,
                         device=s.device)
        return torch.cat([s.view(torch.int32)[full:], pad]).view(torch.uint32)

    tail = _run([w if w is None else
                 scratch(w, 0x7FFFFFFF if i == 1 and flip1 else -1)
                 for i, w in enumerate(words)],
                [scratch(r, 0) for r in riders], which, plan, flip1, stored)
    if not full:
        return tuple([t[:n] for t in ts] for ts in tail)
    head = _run([w if w is None else w[:full] for w in words],
                [r[:full] for r in riders], which, plan, flip1, stored)
    return tuple([torch.cat([h.view(torch.int32),
                             t.view(torch.int32)[:n - full]]
                            ).view(torch.uint32) for h, t in zip(hs, ts)]
                 for hs, ts in zip(head, tail))


def _run(words, riders, which: str, plan, flip1: bool, stored: bool):
    """One call of the design's kernels over all of `words`' rows: a
    launch a batch of riders (each batch past the first sorts again and
    keeps only its riders)."""
    key = words[0]
    launches = ({"bitonic_stage": 0, "cluster_sort": 1} if which == "merge"
                else plan.launches())
    batches = [riders[i:i + MAX_RIDERS]
               for i in range(0, len(riders), MAX_RIDERS)] or [[]]
    out_r = []
    for i, batch in enumerate(batches):
        dst = [torch.empty_like(key)
               if stored or (i == 0 and w is not None) else None
               for w in words]
        outs = [torch.empty_like(r) for r in batch]
        if which == "merge":
            _launch_merge(words, dst, batch, outs)
        else:
            _launch_network(words, dst, batch, outs, plan, flip1)
        _count(launches)
        if i == 0:
            out_w = dst[:-1] if words[-1] is None else dst
        out_r += outs
    return out_w, out_r


def _count(launches: dict) -> None:
    for k, v in launches.items():
        KERNEL_LAUNCHES[k] += v


def sort_tiles(keys: torch.Tensor, tile_rows: int = 128,
               interpret: bool | None = None,
               ce: str = "roll") -> torch.Tensor:
    """Sort uint32 keys ascending within each tile (keys only)."""
    if keys.device.type == "cpu":
        return sort_tiles_plain(keys, tile_rows)
    tile_log2 = _check_tiles(keys, (), tile_rows)
    with annotate("lsd.kernel.sort_tiles"):
        (ok,), _ = _sort_words([keys], [], tile_log2, flip1=False)
    LAUNCHES["sort_tiles"] += 1
    return ok


def sort_tiles_kv(keys: torch.Tensor, values: torch.Tensor,
                  tile_rows: int = 128, interpret: bool | None = None,
                  ce: str = "roll"):
    """(key, value)-sort within each tile of `tile_rows * 128` rows; the
    value breaks ties as a signed int32 and moves with its key. Pass
    unique values (e.g. row ids < 2^31) for a stable key sort. Returns
    (sorted_keys, values_along)."""
    if keys.device.type == "cpu":
        return sort_tiles_kv_plain(keys, values, tile_rows)
    tile_log2 = _check_tiles(keys, (values,), tile_rows)
    with annotate("lsd.kernel.sort_tiles_kv"):
        (ok, ov), _ = _sort_words([keys, values], [], tile_log2, flip1=True)
    LAUNCHES["sort_tiles_kv"] += 1
    return ok, ov


def sort_tiles_multi(keys: torch.Tensor, values, tile_rows: int = 128,
                     interpret: bool | None = None, ce: str = "roll",
                     ncmp: int | None = None):
    """Tile-local sort with any number of payload streams.

    values: list of (n,) uint32. The first ncmp-1 (default 1) are compared
    after the key, unsigned; the rest ride uncompared, in input order
    within rows tied on the compared words. Returns
    (sorted_keys, [payloads...])."""
    values = list(values)
    if keys.device.type == "cpu":
        return sort_tiles_multi_plain(keys, values, tile_rows, ncmp=ncmp)
    tile_log2 = _check_tiles(keys, values, tile_rows)
    ncmp = _ncmp(values, ncmp)
    compared, riders = values[:ncmp - 1], values[ncmp - 1:]
    words = [keys, *compared] + ([None] if riders else [])
    with annotate("lsd.kernel.sort_tiles_multi"):
        out, out_r = _sort_words(words, riders, tile_log2, flip1=False)
    LAUNCHES["sort_tiles_multi"] += 1
    return out[0], [*out[1:], *out_r]
