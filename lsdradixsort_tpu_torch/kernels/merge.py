"""8-way merge pass — the port of `merge_pass_multi` and its wrappers
`merge_pass` and `merge_pass_kv` (lsdradixsort_tpu/kernels/merge.py).

One pass turns every group of KWAY = 8 consecutive sorted runs of
`run_len` rows into one sorted run (the last group may hold fewer runs).
Rows are ordered by the key, then by payload 0 when ncmp = 2 (the
default with payloads), both unsigned as in the TPU kernel
(merge.py:388-389); equal rows keep run order, then input order. Every
payload moves with its row.

The TPU kernel needed sample tables from an XLA prepass
(`merge_pass_tables`), VMEM quarter buffers and DMA windows, and a skew
fallback for tables that overflow the buffer. The Hopper kernel
(``csrc/merge.cu``) computes each row's output position directly by
binary search in the other runs of its group, so it needs no tables and
has no capacity to overflow.

On a CUDA tensor `merge_pass_multi` launches that kernel; on a CPU tensor
it runs the plain PyTorch version (a stable sort of each group), which
`chip_smoke.py` also runs on the card to check the kernel. `LAUNCHES` and
`PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.convert import order_key, take_rows
from lsdradixsort_tpu_torch.kernels import _build

KWAY = 8              # fan-in per merge pass
MAX_STREAMS = 8       # key + payloads the kernel moves in one pass
# Defaults of the JAX merge engine's TPU tuning knobs (sample stride and
# VMEM buffer, in elements). ops/sort.py accepts and ignores those knobs.
DEF_BLK = 2048
DEF_BUF = 1 << 20

LAUNCHES = {"merge_pass_multi": 0}
PLAIN_CALLS = {"merge_pass_multi": 0}


def _check(keys: torch.Tensor, vals, run_len: int, ncmp) -> int:
    """Validate the inputs; return ncmp."""
    n = keys.shape[0]
    if run_len < 1 or n % run_len:
        raise ValueError(f"n={n} must be a multiple of run_len={run_len}")
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
    if ncmp == 3:
        raise NotImplementedError(
            "ncmp=3 (the 64-bit single-chain merge) lands with sort64, "
            "ROADMAP Queue A item 5")
    if ncmp not in (1, 2) or ncmp > 1 + len(vals):
        raise ValueError(f"ncmp={ncmp} with {len(vals)} payloads")
    return ncmp


def merge_pass_multi_plain(keys, vals, run_len: int,
                           ncmp: int | None = None):
    """Plain PyTorch version: a stable sort of each group of KWAY runs by
    the compared streams."""
    vals = list(vals)
    ncmp = _check(keys, vals, run_len, ncmp)
    PLAIN_CALLS["merge_pass_multi"] += 1
    streams = [keys, *vals]
    n = keys.shape[0]
    group = KWAY * run_len
    full = n - n % group
    parts = []
    for lo, hi in ((0, full), (full, n)):     # full groups, then the rest
        if hi > lo:
            seg = [s[lo:hi] for s in streams]
            key = order_key(seg[:ncmp]).view(-1, min(group, hi - lo))
            perm = torch.sort(key, dim=1, stable=True).indices
            parts.append([take_rows(s, perm) for s in seg])
    out = [torch.cat(cols) for cols in zip(*parts)] if parts else streams
    return out[0], out[1:]


def merge_pass_multi(keys: torch.Tensor, vals, run_len: int,
                     ncmp: int | None = None):
    """One KWAY merge pass with any number of payload streams (up to 7).

    keys and vals: (n,) uint32, sorted in runs of run_len by the compared
    streams (the key, then vals[0] when ncmp = 2); n % run_len == 0.
    Returns (sorted_keys, [payloads...]) in runs of KWAY * run_len."""
    vals = list(vals)
    if keys.device.type == "cpu":
        return merge_pass_multi_plain(keys, vals, run_len, ncmp)
    ncmp = _check(keys, vals, run_len, ncmp)
    streams = [keys, *vals]
    outs = [torch.empty_like(s) for s in streams]
    with torch.cuda.device(keys.device):
        fn = _build.function("lsd_merge_pass", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        _build.check(fn(_build.pointers(streams), _build.pointers(outs),
                        len(streams), keys.shape[0], run_len, ncmp,
                        ctypes.c_void_p(stream)), "lsd_merge_pass")
    LAUNCHES["merge_pass_multi"] += 1
    return outs[0], outs[1:]


def merge_pass_kv(keys: torch.Tensor, vals: torch.Tensor, run_len: int):
    """One merge pass carrying one payload, which breaks ties: a stable key
    merge when vals are unique and follow run order (e.g. row ids)."""
    ok, (ov,) = merge_pass_multi(keys, [vals], run_len)
    return ok, ov


def merge_pass(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """One keys-only merge pass: sorted runs of run_len -> KWAY*run_len."""
    out, _ = merge_pass_multi(keys, [], run_len)
    return out
