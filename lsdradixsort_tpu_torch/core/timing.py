"""Device timing with CUDA event pairs.

Counterpart of lsdradixsort_tpu/core/timing.py. As in the reference
(CudaUtils.cpp:24-29, LSDRadixSort.cu:998-1009), a pair of CUDA events
brackets device work only: each run is enqueued between its own two
events on the current stream, and the elapsed times are read after one
synchronise. PyTorch dispatches straight to the card, so there is no
dispatch latency to amortise. `time_host` times host functions (the
CPU-golden bar of the bench runner) on the wall clock.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from dataclasses import dataclass

import torch


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (``name, power.limit``), to stand beside every number measured."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


@dataclass
class Timing:
    seconds: float          # median per-call device time
    iters: int              # timed runs the median is taken over
    calls_per_iter: int = 1

    @property
    def ms(self) -> float:
        return self.seconds * 1e3

    def gelems_per_s(self, n: int) -> float:
        return n / self.seconds / 1e9

    def gbytes_per_s(self, nbytes: int) -> float:
        return nbytes / self.seconds / 1e9


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> Timing:
    """Median device time of `fn(*args)` over `iters` runs after `warmup`
    runs, each run bracketed by its own CUDA event pair."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures device time: no CUDA device")
    for _ in range(warmup):
        fn(*args)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events)
    return Timing(seconds=ms / 1e3, iters=iters)


def time_host(fn, *args, iters: int = 3) -> Timing:
    """Best wall-clock time of a host (numpy / native) function over
    `iters` runs after one warm-up run: the CPU-golden bar (reference
    pattern: LSDRadixSort.cu:984-990)."""
    fn(*args)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return Timing(seconds=best, iters=iters)
