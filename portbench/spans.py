"""The port's own spans and counters over one traced run of a cell: where
the device's time and the host's idle time go by the port's stages, and
what its counters counted a call. A reading beside the result line, not
a metric: the result line carries neither.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python3 -m portbench ... --trace 1` does (run.run_cell:
the same set-up, warm-up, window under torch.profiler and check) and
prints the card's name, then one JSON line:

- `spans`: {span: {"per_call", "device_ms", "idle_ms"}} for each of the
  port's spans (`lsd.*`, lsdradixsort_tpu_torch/core/profiling.py) seen
  in the window: how often it opened a call, the device ms a call of the
  operations it owns, and the idle ms a call put down to it;
- `counters`: the rise of the port's counters (`profiling.counts()`) a
  call of the window;
- `owned_pct`: % of the window's device time that some span owns;
- `sort_pct`: % that `lsd.merge_sort` owns, its kernel spans included:
  what a faster sort could save at most;
- `glue_ms`: device ms a call owned by a span of the port and by none of
  its kernel spans (`lsd.kernel.*`): the torch glue, found where it is
  launched rather than by kernel names (metrics/glue.ms.py).

A device operation's owners are the spans open on the window's thread at
its launch, the CUDA runtime call that the profiler gives the same
correlation id; the innermost one owns it. An idle gap's seconds go to
the innermost span that the host was in then, or to `harness`.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

from portbench import layout, run, trace as tr

LSD = "lsd."                # the port's spans
KERNEL = "lsd.kernel."      # its spans around a kernel launch
SORT = "lsd.merge_sort"     # its framework sort
HARNESS = "harness"         # idle time in no span of the port
_RUNTIME = "cu"     # CUDA runtime and driver calls: cudaLaunchKernel, ...


@dataclass
class Op(tr.Event):
    corr: int | None = None     # a device op's and its launch's shared id


@dataclass
class Reading:
    """The window's device operations by owner, and its idle seconds by
    span."""
    device: list[Op]                    # clipped to the window
    owners: list[tuple]                 # the spans open at each launch
    opened: Counter = field(default_factory=Counter)     # span -> times
    idle: dict[str, float] = field(default_factory=dict)  # span -> s
    busy_s: float = 0.0

    def owned_s(self, keep) -> float:
        """Device seconds of the operations whose owners `keep` accepts."""
        return sum(e.end - e.start for e, path in zip(self.device,
                                                      self.owners)
                   if keep(path)) / 1e9

    def table(self, calls: int) -> dict:
        """{span: {"per_call", "device_ms", "idle_ms"}}, a call."""
        rows: dict[str, dict] = {}

        def row(name):
            return rows.setdefault(name, {"per_call": 0.0, "device_ms": 0.0,
                                          "idle_ms": 0.0})
        for name, n in self.opened.items():
            row(name)["per_call"] += n
        for e, path in zip(self.device, self.owners):
            if path:
                row(path[-1])["device_ms"] += (e.end - e.start) / 1e6
        for name, secs in self.idle.items():
            if name != HARNESS:
                row(name)["idle_ms"] += secs * 1e3
        return {name: {k: v / calls for k, v in r.items()}
                for name, r in sorted(rows.items())} if calls else {}

    def summary(self, calls: int) -> dict:
        total_s = sum(e.end - e.start for e in self.device) / 1e9

        def share(keep):
            return 100.0 * self.owned_s(keep) / total_s if total_s else None
        glue_s = self.owned_s(lambda path: path and not any(
            p.startswith(KERNEL) for p in path))
        return {"spans": self.table(calls),
                "owned_pct": share(bool),
                "sort_pct": share(lambda path: SORT in path),
                "glue_ms": 1e3 * glue_s / calls if calls else None}


def segments(spans: list[tr.Event], w0: int, w1: int):
    """[(start, end, names)] covering [w0, w1): the spans (nested, on one
    thread) open then, outermost first."""
    segs = []
    stack: list[tr.Event] = []
    cursor = w0

    def emit(to):
        nonlocal cursor
        if to > cursor:
            segs.append((cursor, to, tuple(e.name for e in stack)))
            cursor = to

    for e in sorted(spans, key=lambda e: (e.start, -e.end)):
        if e.end <= w0 or e.start >= w1:
            continue
        while stack and stack[-1].end <= e.start:
            emit(stack[-1].end)
            stack.pop()
        emit(max(e.start, w0))
        if stack:       # clip a span that outlives its parent
            e = tr.Event(e.name, e.start, min(e.end, stack[-1].end))
        stack.append(e)
    while stack:
        emit(min(stack[-1].end, w1))
        stack.pop()
    emit(w1)
    return segs


def read(host: list[Op], device: list[Op]) -> Reading | None:
    """The Reading of the window span among host events (runtime calls
    with their correlation ids); None without one."""
    win = next((e for e in host if e.name == tr.WINDOW), None)
    if win is None:
        return None
    w0, w1 = win.start, win.end
    dev = [Op(e.name, max(e.start, w0), min(e.end, w1), corr=e.corr)
           for e in device if e.end > w0 and e.start < w1]
    spans = [e for e in host if e.thread == win.thread
             and e.name.startswith(LSD) and e.end > w0 and e.start < w1]
    segs = segments(spans, w0, w1)
    starts = [a for a, _, _ in segs]
    launches = {e.corr: e.start for e in host if e.corr is not None}
    owners = []
    for e in dev:
        t = launches.get(e.corr)
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        owners.append(segs[i][2] if i >= 0 and t < segs[i][1] else ())
    busy = tr.union((e.start, e.end) for e in dev)
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if w1 > cursor:
        gaps.append((cursor, w1))
    by_span = [(a, b, names[-1] if names else HARNESS)
               for a, b, names in segs]
    return Reading(device=dev, owners=owners,
                   opened=Counter(e.name for e in spans),
                   idle=tr.attribute(gaps, by_span),
                   busy_s=sum(b - a for a, b in busy) / 1e9)


def from_profiler(prof) -> Reading | None:
    """The Reading of a finished torch.profiler.profile. As
    trace.from_profiler, the spans mirrored onto the device's timeline
    are left out; a device op and the runtime call that launched it keep
    the correlation id that the profiler gives both."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        corr = (e.correlation_id()
                if on_device or e.name().startswith(_RUNTIME) else None)
        op = Op(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                corr)
        (device if on_device else host).append(op)
    host_names = {e.name for e in host}
    return read(host, [e for e in device if e.name not in host_names])


@contextlib.contextmanager
def _kept_profilers(kept: list):
    """run_cell keeps no handle on its profiler: for the one run, the
    profiler class it makes is one that puts itself in `kept` when it
    stops."""
    import torch.profiler
    base = torch.profiler.profile

    class Kept(base):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out
    torch.profiler.profile = Kept
    try:
        yield
    finally:
        torch.profiler.profile = base


def measure(cell: str, seed: int, seconds: float, **run_options) -> dict:
    """One traced run of `cell` (run.run_cell's options): its check,
    calls, busy and window seconds, and the spans' and counters'
    readings."""
    from lsdradixsort_tpu_torch.core import profiling
    entry = layout.module("entries", layout.workload(cell)["entry"])
    rises: list[dict] = []

    def counted(a):
        before = profiling.counts()
        out = entry.call(a)
        rises.append({k: v - before[k]
                      for k, v in profiling.counts().items()})
        return out

    kept: list = []
    with _kept_profilers(kept):
        result = run.run_cell(cell, seed, seconds, True, call=counted,
                              **run_options)
    calls = result["attempted"]
    reading = from_profiler(kept[-1])
    window = rises[len(rises) - calls:]
    out = {"cell": cell, "seed": seed, "correct": result["correct"],
           "attempted": calls, "busy_s": reading.busy_s,
           "window_s": result["device"].get("window_s"),
           "counters": {k: sum(r[k] for r in window) / calls
                        for k in profiling.counts()} if calls else {}}
    out.update(reading.summary(calls))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run._use_checkout_caches()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.seconds,
                  start=time.perf_counter())
    print(f"# card: {run._card_label()}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
