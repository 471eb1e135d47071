"""One run of one cell: set-up, warm-up, the measured window, the check.

A cell is an entry of BENCHMARK.json's workloads: a configuration
(configs/<config>.json) under a traffic mix (traffic/<traffic>.json).
Its own file, workloads/<cell>.json, names the entry that the window
drives, the plain reference that judges it, the warm-up and sample
sizes and the limits of the numbers compared. A run:

1. makes the configuration's data on the device from --seed
   (data/<generator>.py) and hands it to the entry (entries/<entry>.py);
2. warms up with the cell's own shapes (`warmup_calls` calls);
3. drives the entry in a closed loop, one caller, for --seconds: each
   call ends in a device synchronize and is timed on the host's clock;
   a sample of the calls, drawn from the seed, keeps its answer;
4. reads the device's peak memory, then checks each kept answer against
   the plain reference (reference/<entry>.py) and compares the numbers
   with the cell's `limits`;
5. prints the numbers compared, each beside its limit, as the last lines
   on stderr, and one JSON result line last on stdout. With --trace 1
   the window runs under torch.profiler and the result carries the
   per-layer metrics, the device's busy and window seconds and a
   breakdown; without, the end-to-end metrics.

Set-up counts from the start of the process to the start of the window.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field

from portbench import layout, peaks, trace as tr

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lsdradixsort_tpu")

# build and kernel caches, at fixed paths inside the checkout
_CACHES = {
    "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
    "TRITON_CACHE_DIR": "build/triton",
    "PYTORCH_KERNEL_CACHE_PATH": "build/torch_kernel_cache",
    "CUDA_CACHE_PATH": "build/cuda_cache",
}


@dataclass
class Window:
    """What a run measured: the metric readers' only input."""
    calls: int                  # calls in the window
    seconds: float              # the window, host clock
    latencies: list[float]      # each call's seconds, host clock
    setup_s: float
    work: dict                  # one call's rows, least_bytes, sort_rows,
    #                             sort_streams (entries/<entry>.py work)
    kind: str                   # the device's name
    trace: tr.Trace | None = None
    kernel_names: dict = field(default_factory=dict)

    @property
    def rows(self) -> int:
        return self.calls * self.work["rows"]

    @property
    def peak_bytes_per_s(self) -> float | None:
        return peaks.hbm_bytes_per_s(self.kind)

    def percentile(self, pct: int) -> float:
        """The pct-th percentile of the calls' latency, nearest rank."""
        lat = sorted(self.latencies)
        return lat[max(0, -(-pct * len(lat) // 100) - 1)]

    def function_roofline(self, fn: str) -> float | None:
        """% of the card's memory roofline that the kernels of `fn` (a
        kernel_names function) reach: each launch handed the call's
        sort_rows rows of sort_streams u32 streams, read once and written
        once, over their summed device time."""
        spec = self.kernel_names.get("functions", {}).get(fn)
        if self.trace is None or spec is None or not self.peak_bytes_per_s:
            return None
        launches, _ = self.trace.matching([spec["launch"]])
        _, secs = self.trace.matching(spec["kernels"])
        if launches == 0 or secs <= 0:
            return None
        moved = launches * peaks.stream_pass_bytes(self.work["sort_rows"],
                                                   self.work["sort_streams"])
        return 100.0 * moved / self.peak_bytes_per_s / secs


def _use_checkout_caches() -> None:
    for var, rel in _CACHES.items():
        os.environ.setdefault(var, str(layout.CHECKOUT / rel))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _card_label() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=False)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown (nvidia-smi gave nothing)"


def _merged(base: dict, extra: dict | None) -> dict:
    return {**base, **(extra or {})}


def _drive(entry, state, call, sync, seconds: float, first: int,
           keep: int, rng: random.Random, span):
    """The measured window: calls one after another, each timed from its
    start to the end of the synchronize after it, until `seconds` have
    passed. Returns (latencies, window seconds, [(call index, answer)]),
    the answers a reservoir sample of `keep` calls drawn by `rng`."""
    samples: list[tuple[int, object]] = []
    latencies: list[float] = []
    i = first
    with span(tr.WINDOW):
        t_start = t_end = time.perf_counter()
        while t_end - t_start < seconds:
            a = entry.args(state, i)
            t0 = time.perf_counter()
            with span(tr.CALL):
                out = call(a)
            with span(tr.SYNC):
                sync()
            t_end = time.perf_counter()
            latencies.append(t_end - t0)
            k = len(latencies) - 1
            if k < keep:
                samples.append((i, out))
            else:
                j = rng.randrange(k + 1)
                if j < keep:
                    samples[j] = (i, out)
            del out, a
            i += 1
    return latencies, t_end - t_start, samples


def _check(entry, ref, state, samples, limits: dict):
    """Each sampled answer against the reference's from the inputs that
    call was handed: (correct, {number: sum over the samples})."""
    checks = {name: 0 for name in limits}
    while samples:
        idx, out = samples.pop()
        want = ref.expect(entry.args(state, idx))
        for name, value in ref.compare(out, want).items():
            checks[name] = checks.get(name, 0) + value
        del out, want
    correct = all(name in limits and value <= limits[name]
                  for name, value in checks.items())
    return correct, checks


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             start: float, device: str = "cuda", overrides: dict | None
             = None, call=None, bench: dict | None = None):
    """Run `cell` once and return its result line as a dict.

    `call` replaces the entry's call: the control's command line puts the
    reference's control there, the tests a fault. `overrides` ({"config":
    {...}, "traffic": {...}}) and `device` "cpu" (the port's plain
    versions) are the CPU tests'. The benchmark's command line uses none
    of them."""
    import torch
    t_begin = time.perf_counter()
    bench = bench or layout.benchmark()
    names = layout.cell_entry(bench, cell)
    spec = layout.workload(cell)
    overrides = overrides or {}
    cfg = _merged(layout.config(names["config"]), overrides.get("config"))
    traffic = _merged(layout.traffic(names["traffic"]),
                      overrides.get("traffic"))
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    entry = layout.module("entries", spec["entry"])
    ref = layout.module("reference", spec["reference"])
    t_import = time.perf_counter()
    data = layout.module("data", cfg["generator"]).make(cfg, traffic, seed,
                                                         device)
    state = entry.prepare(data, cfg, traffic)
    del data
    call = call or entry.call
    work = entry.work(entry.args(state, 0))
    sync()
    t_data = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    warmup = int(spec["warmup_calls"])
    warm = []
    for i in range(warmup):
        t = time.perf_counter()
        out = call(entry.args(state, i))
        sync()
        warm.append(time.perf_counter() - t)
        del out
    setup_s = time.perf_counter() - start
    # where set-up went: the start to the run (torch's import, the look
    # for a card), the port's import, the data (with the device's
    # start-up), each warm-up call (the first loads the kernels)
    setup_parts = (f"setup_s {setup_s:.3f}: start {t_begin - start:.3f}, "
                   f"import {t_import - t_begin:.3f}, "
                   f"data {t_data - t_import:.3f}, warm-up "
                   + " ".join(f"{x:.3f}" for x in warm))

    prof, span = None, contextlib.nullcontext
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        span = torch.profiler.record_function
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's way
    with prof if prof is not None else contextlib.nullcontext():
        latencies, seconds_run, samples = _drive(
            entry, state, call, sync, seconds, warmup,
            int(spec["check_calls"]), random.Random(seed), span)
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(loaded)
    trace = tr.from_profiler(prof) if prof is not None else None
    del prof
    correct, checks = _check(entry, ref, state, samples, spec["limits"])

    kind = torch.cuda.get_device_name(torch.device(device)) if on_card \
        else "cpu"
    window = Window(calls=len(latencies), seconds=seconds_run,
                    latencies=latencies, setup_s=setup_s, work=work,
                    kind=kind, trace=trace,
                    kernel_names=layout.kernel_names())
    metrics = {}
    for m in layout.metrics_for(bench, cell, traced):
        value = layout.metric_reader(m["name"]).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": names["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    print(setup_parts, file=sys.stderr)
    result["checks"] = {name: {"value": value,
                               "limit": spec["limits"].get(name)}
                        for name, value in checks.items()}
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of jax, jaxlib, flax or the JAX package "
                         f"are loaded: {', '.join(names)}")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def print_result(result: dict) -> None:
    """The numbers compared as the last lines on stderr, then the result
    as the last line on stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, start: float, call_from=None) -> int:
    """The command line. `call_from(spec)` gives a call to put in the
    entry's place (the control's command line); the benchmark has none."""
    args = parse(argv)
    _use_checkout_caches()
    import torch
    torch.set_num_threads(1)
    bench = layout.benchmark()
    chips = layout.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    call = call_from(layout.workload(args.workload)) if call_from else None
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), start=start, call=call,
                          bench=bench)
    except ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(f"# card: {_card_label()}", flush=True)
    print_result(result)
    return 0
