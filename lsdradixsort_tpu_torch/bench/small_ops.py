"""The composed pass's small kernels beside their PyTorch calls.

    python -m lsdradixsort_tpu_torch.bench.small_ops

`block_scans` of the histogram rows and `transpose_any` of the histogram
are launched once in every pass of the composed LSD sort
(ops/sort.py `_pass_destinations`) on (blocks, 2^r) histograms: 16384
blocks for 2^27 keys at block 2^13. There their event interval is mostly
the host's time to issue the call, so each record splits it:

  * `ms`: the CUDA-event interval of one call (core/timing.py `time_fn`,
    median of ITERS), taken in turns with the library call, ALTERNATIONS
    times, the median of those medians; each turn's median in `ms_turns`;
  * `host_ms`: the wall time the host takes to issue one call on an idle
    queue (median of ITERS, no synchronise inside);
  * `device_ms`: the traced device time of one call (bench/flagship.py
    `profile_kernels`, busy time of RUNS calls over RUNS) and
    `kernels`, the launches it counted a call;
  * the same for the library call (`library_*`), `bound_ms` (bytes read
    and written over the card's measured copy ceiling) and `card`.

Shapes: both kernels at r = 8, 4, 2, 1 on the histograms of 2^27 keys
(seed 0), then the shapes whose times must stay where they were:
`block_prefix_sums` of 2^27 words in blocks of 2^13 and `transpose_tiled`
at (16384, 256) and (8192, 16384). Then `host_parts` at r = 8 and 1: the
host's time a call of each step of the two wrappers (and of the ways to
make two outputs), beside their library calls. One JSON line a record.
There is no CPU fallback: without a CUDA device it fails.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from lsdradixsort_tpu_torch.bench.flagship import profile_kernels
from lsdradixsort_tpu_torch.core import roofline
from lsdradixsort_tpu_torch.core.datagen import random_keys
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
from lsdradixsort_tpu_torch.kernels import histogram as H
from lsdradixsort_tpu_torch.kernels import scan as SC
from lsdradixsort_tpu_torch.kernels import transpose as TR

N = 1 << 27
BLOCK = 1 << 13
ITERS = 5
ALTERNATIONS = 3
RUNS = 5


def host_ms(fn, iters: int = ITERS) -> float:
    """Median wall time of issuing fn() on an idle queue."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(label: str, fn, runs: int = RUNS):
    """(device ms of one call, kernels a call) from one trace of `runs`
    calls."""
    prof = profile_kernels(label, lambda: [fn() for _ in range(runs)])
    return prof.get("busy_ms", 0.0) / runs, prof["kernels"] / runs


def in_turns(kernel, library, alternations: int = ALTERNATIONS,
             iters: int = ITERS):
    """Event-interval medians of kernel() and library(), timed in turns:
    kernel, library, kernel, library, ..."""
    turns = {"kernel": [], "library": []}
    for _ in range(alternations):
        turns["kernel"].append(time_fn(kernel, iters=iters).ms)
        turns["library"].append(time_fn(library, iters=iters).ms)
    return turns


def record(name: str, shape: str, kernel, library, nbytes: int,
           ceiling_gbps: float, card: str) -> dict:
    """Both calls timed in turns, their host issue and traced device
    times, and the bound."""
    turns = in_turns(kernel, library)
    dk, nk = device_ms(name, kernel)
    dl, nl = device_ms(f"{name} library", library)
    return {"kernel": name, "shape": shape,
            "ms": statistics.median(turns["kernel"]),
            "ms_turns": turns["kernel"], "host_ms": host_ms(kernel),
            "device_ms": dk, "kernels": nk,
            "library_ms": statistics.median(turns["library"]),
            "library_ms_turns": turns["library"],
            "library_host_ms": host_ms(library),
            "library_device_ms": dl, "library_kernels": nl,
            "bound_ms": nbytes / (ceiling_gbps * 1e9) * 1e3,
            "card": card}


def hist_cases(hist: torch.Tensor):
    """(name, shape, kernel, library, bytes) of both kernels on one
    (blocks, 2^r) histogram, as the composed pass calls them."""
    nb, bins = hist.shape
    flat = hist.view(-1)
    shape = f"histogram r={bins.bit_length() - 1} ({nb}, {bins})"
    yield ("block_prefix_sums", shape, lambda: SC.block_scans(flat, bins),
           lambda: torch.cumsum(hist.view(torch.int32), 1,
                                dtype=torch.int32),
           8 * nb * bins + 4 * nb)
    yield ("transpose_tiled", shape, lambda: TR.transpose_any(hist),
           lambda: hist.t().contiguous(), 8 * nb * bins)


def path_cases(keys: torch.Tensor, rs=(8, 4, 2, 1), block: int = BLOCK):
    """hist_cases of each r's histogram of `keys`."""
    for r in rs:
        yield from hist_cases(H.block_digit_histograms(keys, r, 0, block))


def host_per_call_ms(fn, calls: int = 200, batches: int = 5) -> float:
    """Median over batches of the host's wall time a call, `calls` calls
    issued back to back after a synchronise."""
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(per)


def host_parts(hist: torch.Tensor, card: str) -> dict:
    """Host ms a call of each step the two wrappers take on `hist`, and of
    their library calls."""
    nb, bins = hist.shape
    flat = hist.view(-1)
    n = flat.shape[0]
    dev = hist.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    buf = torch.empty(n + nb, dtype=hist.dtype, device=hist.device)
    out = torch.empty((bins, nb), dtype=hist.dtype, device=hist.device)
    seg_scan, transpose = SC._seg_scan(), TR._transpose()
    ptr, optr, xptr = buf.data_ptr(), out.data_ptr(), flat.data_ptr()
    steps = {
        "block_scans": lambda: SC.block_scans(flat, bins),
        "transpose_any": lambda: TR.transpose_any(hist),
        "cumsum(dim=1)": lambda: torch.cumsum(hist.view(torch.int32), 1,
                                              dtype=torch.int32),
        ".t().contiguous()": lambda: hist.t().contiguous(),
        "check": lambda: SC._check(flat),
        "contiguous": lambda: flat.contiguous(),
        "torch.empty(n + n/seg)": lambda: torch.empty(
            n + nb, dtype=flat.dtype, device=flat.device),
        "new_empty(n + n/seg)": lambda: flat.new_empty(n + nb),
        "two views": lambda: (buf[:n], buf[n:]),
        "split_with_sizes": lambda: buf.split_with_sizes([n, nb]),
        "two new_empty, n and n/seg": lambda: (flat.new_empty(n),
                                               flat.new_empty(nb)),
        "device.index": lambda: flat.device.index,
        "get_device()": lambda: flat.get_device(),
        "is_cuda": lambda: flat.is_cuda,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "lsd_seg_scan C call": lambda: seg_scan(xptr, ptr, ptr + 4 * n, n,
                                                bins, dev, stream),
        "lsd_transpose C call": lambda: transpose(xptr, optr, nb, bins, dev,
                                                  stream),
        "ctypes call alone (lsd_exclusive_scan, n = 0)": lambda: SC._lookback()
        [1](xptr, ptr, ptr, 0, dev, stream),
    }
    return {"host_parts": f"histogram r={bins.bit_length() - 1} ({nb}, "
            f"{bins})", "ms_a_call": {k: host_per_call_ms(f)
                                      for k, f in steps.items()},
            "card": card}


def steady_cases(keys: torch.Tensor):
    """The shapes whose times this redesign must leave as they were."""
    n = keys.shape[0]
    yield ("block_prefix_sums", "2^27 words, block 2^13",
           lambda: SC.block_prefix_sums(keys, BLOCK),
           lambda: torch.cumsum(keys.view(torch.int32).view(-1, BLOCK), 1,
                                dtype=torch.int32),
           8 * n + 4 * (n // BLOCK))
    for shape in ((16384, 256), (8192, 16384)):
        a = keys[:shape[0] * shape[1]].view(shape)
        yield ("transpose_tiled", f"{shape}",
               lambda a=a: TR.transpose_tiled(a, 256),
               lambda a=a: a.t().contiguous(), 8 * a.numel())


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("small_ops: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label()
    ceiling = roofline.measure_copy_gbps(dev)
    keys = random_keys(N, 0, dev)
    for case in (*path_cases(keys), *steady_cases(keys)):
        print(json.dumps(record(*case, ceiling, card)), flush=True)
    for r in (8, 1):
        print(json.dumps(host_parts(
            H.block_digit_histograms(keys, r, 0, BLOCK), card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
