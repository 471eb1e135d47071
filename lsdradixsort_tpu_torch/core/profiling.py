"""Profiling and tracing — the port of lsdradixsort_tpu/core/profiling.py.

The JAX package captures xprof traces with `jax.profiler`; here the same
helpers sit on `torch.profiler`, whose Chrome/TensorBoard trace shows the
host ops and the CUDA kernels on one timeline (the reference's cudaEvent
pairs and Nsight captures, SURVEY.md §5).

    from lsdradixsort_tpu_torch.core.profiling import annotate, trace

    with trace("/tmp/lsd_trace"):          # *.pt.trace.json written here
        with annotate("sort_pass_0"):
            out = sort_kv(keys, vals)
        torch.cuda.synchronize()

Per-kernel device times and the idle share of one run are
`bench/flagship.py` `profile_kernels`.

The port measures itself with the same two tools. `annotate` spans sit on
the hot path (`lsd.<op>` around each public call, `lsd.<stage>` around the
stages of a call, `lsd.kernel.<wrapper>` around each kernel launch): they
reach the profiler's timeline, on its clock, while a profiler runs, and
cost one flag check otherwise. `COUNTS` holds counters that are always on,
on every device: `host_syncs` (device values read on the host, each
through `host_value` or `to_host`), `int64_bytes` (bytes of the int64
columns that `core/convert.py` `u32_to_i64` makes), `record_bytes`
(bytes of whole records that `kernels/records.py` `gather_records`
moves) and `ragged_sorts` (merge-engine sorts, ops/sort.py
`_merge_chain`, whose n is not a power-of-two count of whole tiles: a
short last tile or a short last run). `counts()` copies them; a reader
takes the difference of two copies.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Trace the enclosed computation with torch.profiler (CPU activity,
    and CUDA when a card is present) and write a Chrome/TensorBoard trace
    into `log_dir` when the block ends (open it with
    `tensorboard --logdir <log_dir>`, chrome://tracing or ui.perfetto.dev).
    `create_perfetto_link` is the JAX profiler's option to serve the trace
    to the Perfetto UI: accepted for API parity and ignored, since the
    written file opens there as it is."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


_OFF = contextlib.nullcontext()     # every span while no profiler runs
HOST_SYNC = "lsd.host_sync"

COUNTS = {"host_syncs": 0, "int64_bytes": 0, "record_bytes": 0,
          "ragged_sorts": 0}


def annotate(name: str):
    """Named region in the profiler timeline (record_function) while a
    profiler runs; else one shared no-op context, so a span on the hot
    path costs a flag check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def counts() -> dict:
    """A copy of the counters."""
    return dict(COUNTS)


def host_value(t: torch.Tensor):
    """t.item(): a device value read on the host, which waits for the
    device. Counted in `host_syncs`, inside the span `lsd.host_sync`."""
    with annotate(HOST_SYNC):
        COUNTS["host_syncs"] += 1
        return t.item()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(): a device tensor copied to the host, counted as
    `host_value` counts."""
    with annotate(HOST_SYNC):
        COUNTS["host_syncs"] += 1
        return t.cpu()


@contextlib.contextmanager
def stopwatch(name: str, sink=print):
    """Wall-clock bracket for quick ad-hoc timing: a coarse host-side
    bracket — the caller synchronises on its own results (CUDA work is
    asynchronous) for exact numbers."""
    t0 = time.perf_counter()
    yield
    sink(f"[stopwatch] {name}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
