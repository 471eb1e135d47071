"""Lane-bucketed hash table — the port of
lsdradixsort_tpu/kernels/hash_table.py, the small-build join and IN-list
engine ("vmem" in the ops, the JAX package's name).

The table keeps the JAX package's layout exactly, so a table built by
either package probes the same in the other: 128 lane buckets of `rows`
chain slots, as (rows, 128) uint32 key and value planes plus a (1, 128)
uint32 chain-length row, and lane(k) = (k * 0x9E3779B1 mod 2^32) >> 25.

  * `lane_of`, `plan_rows`, `build_table`: torch glue, as they are jnp
    there (a stable sort of the keys by lane, a rank within the lane run
    and one indexed store). `build_table` reports `ok` = False when a
    chain overflows `rows`; callers then take the sort-merge path.
  * `probe_table(tk, tv, cnt, probe_keys, semi)`: (match, build_val) per
    probe key, in probe order; build_val is 0 where unmatched and always
    0 for semi. With duplicate build keys the last chain match wins.

On a CUDA tensor `probe_table` launches ``csrc/hash_table.cu`` (the table
staged in shared memory when it fits, read through L1/L2 otherwise; the
header gives the design and what bounds it); on a CPU tensor it runs the
plain PyTorch version (a loop over the chain rows with gathers), which
`chip_smoke.py` also runs on the card to check the kernel. `blk_rows` and
`interpret` are the TPU's knobs: accepted and ignored. `LAUNCHES` and
`PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import math

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
MIX = 0x9E3779B1                # odd (golden-ratio) multiplier
DEF_BLK_ROWS = 512

LAUNCHES = {"probe_table": 0}
PLAIN_CALLS = {"probe_table": 0}


def lane_of(keys: torch.Tensor) -> torch.Tensor:
    """Bucket lane of each uint32 key (int32): the top 7 bits of
    k * MIX mod 2^32. The product is taken in two 16-bit halves of MIX on
    int64 values, so it never leaves the int64 range."""
    k = u32_to_i64(keys)
    low = k * (MIX & 0xFFFF) + (((k * (MIX >> 16)) & 0xFFFF) << 16)
    return ((low & 0xFFFFFFFF) >> 25).to(torch.int32)


def plan_rows(n_build: int, slack: float = 3.0) -> int:
    """Chain depth for n_build keys over 128 lanes: mean load + slack
    standard deviations (Poisson). Overflow is not fatal: build reports
    it and callers fall back."""
    lam = max(n_build / LANES, 1.0)
    return int(math.ceil(lam + slack * math.sqrt(lam) + 2.0))


def build_table(keys: torch.Tensor, vals: torch.Tensor, rows: int):
    """Build the (rows, 128) table. Returns (tk, tv, cnt, ok): key and
    value planes, the (1, 128) uint32 chain lengths (clamped to rows) and
    a bool scalar tensor, False iff some lane held more than `rows` keys
    (the table then misses them)."""
    dev = keys.device
    nb = keys.shape[0]
    lane = lane_of(keys).to(torch.int64)
    order = torch.sort(lane, stable=True).indices
    slane = lane[order]
    rank = (torch.arange(nb, device=dev)
            - torch.searchsorted(slane, slane, side="left"))
    # slots past the chain go to one spare slot, dropped below
    slot = torch.where(rank < rows, rank * LANES + slane, rows * LANES)
    planes = []
    for x in (keys, vals):
        plane = torch.zeros(rows * LANES + 1, dtype=torch.int32, device=dev)
        plane[slot] = x.view(torch.int32)[order]
        planes.append(plane[:-1].view(rows, LANES).view(torch.uint32))
    cnt = torch.bincount(lane, minlength=LANES)
    ok = (cnt <= rows).all()
    return (*planes, i64_to_u32(cnt.clamp(max=rows)).view(1, LANES), ok)


def _check(tk, tv, cnt, probe_keys) -> None:
    rows = tk.shape[0] if tk.dim() == 2 else -1
    if tk.shape != (rows, LANES) or tv.shape != tk.shape:
        raise ValueError(f"table planes must be (rows, {LANES}), got "
                         f"{tuple(tk.shape)} and {tuple(tv.shape)}")
    if cnt.numel() != LANES:
        raise ValueError(f"cnt must hold {LANES} chain lengths, got "
                         f"{tuple(cnt.shape)}")
    if probe_keys.dim() != 1:
        raise ValueError(f"probe keys must be (n,), got "
                         f"{tuple(probe_keys.shape)}")
    for t in (tk, tv, cnt, probe_keys):
        if t.dtype != torch.uint32:
            raise ValueError(f"the table and probe keys are torch.uint32, "
                             f"got {t.dtype}")
        if t.device != probe_keys.device:
            raise ValueError("the table and the probe keys must be on one "
                             "device")
    if probe_keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {probe_keys.device}")


def probe_table_plain(tk: torch.Tensor, tv: torch.Tensor, cnt: torch.Tensor,
                      probe_keys: torch.Tensor, semi: bool = False,
                      blk_rows: int = DEF_BLK_ROWS,
                      interpret: bool | None = None):
    """Plain PyTorch version: every chain row gathered at each probe's
    lane, the last match kept."""
    _check(tk, tv, cnt, probe_keys)
    PLAIN_CALLS["probe_table"] += 1
    lanes = lane_of(probe_keys).to(torch.int64)
    length = u32_to_i64(cnt.reshape(-1))[lanes]
    key = probe_keys.view(torch.int32)
    match = torch.zeros_like(key, dtype=torch.bool)
    val = torch.zeros_like(key)
    for r in range(tk.shape[0]):
        hit = (tk[r].view(torch.int32)[lanes] == key) & (length > r)
        match |= hit
        if not semi:
            val = torch.where(hit, tv[r].view(torch.int32)[lanes], val)
    return match.to(torch.int32).view(torch.uint32), val.view(torch.uint32)


def probe_table(tk: torch.Tensor, tv: torch.Tensor, cnt: torch.Tensor,
                probe_keys: torch.Tensor, semi: bool = False,
                blk_rows: int = DEF_BLK_ROWS,
                interpret: bool | None = None):
    """Probe every key against the table. Returns (match uint32 0/1,
    build_val uint32), each (n,), in probe order (build_val is 0 where
    unmatched and always 0 for semi=True). Unique build keys assumed; the
    last chain match wins otherwise."""
    if probe_keys.device.type == "cpu":
        return probe_table_plain(tk, tv, cnt, probe_keys, semi)
    _check(tk, tv, cnt, probe_keys)
    with annotate("lsd.kernel.probe_table"):
        tk, tv, cnt = tk.contiguous(), tv.contiguous(), cnt.contiguous()
        probe_keys = probe_keys.contiguous()
        match = torch.empty_like(probe_keys)
        val = torch.empty_like(probe_keys)
        with torch.cuda.device(probe_keys.device):
            fn = _build.function("lsd_probe_table", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
            stream = torch.cuda.current_stream(probe_keys.device).cuda_stream
            _build.check(fn(tk.data_ptr(), tv.data_ptr(), cnt.data_ptr(),
                            probe_keys.data_ptr(), match.data_ptr(),
                            val.data_ptr(), probe_keys.shape[0],
                            tk.shape[0], int(semi), ctypes.c_void_p(stream)),
                         "lsd_probe_table")
    LAUNCHES["probe_table"] += 1
    return match, val
