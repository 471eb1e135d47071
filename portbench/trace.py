"""Reading a torch.profiler trace of the measured window.

After `profile_kernels` of the port's bench/flagship.py, widened from one
call to the whole window: the window is the harness's `portbench.window`
span, the device is busy where any device operation (kernel, copy, set)
runs, and every stretch of the window in which none runs is an idle gap,
named by what the host thread was doing then: the harness span it lies
in (`portbench.call` around the entry, `portbench.sync` around the
synchronize, else the harness itself) and the innermost host event
(a torch op, a CUDA runtime call).
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "portbench.window"
CALL = "portbench.call"
SYNC = "portbench.sync"
_COPIES = ("Memcpy", "Memset")
_TOP = 10           # entries of each breakdown list


@dataclass
class Event:
    name: str
    start: int          # ns
    end: int            # ns
    thread: int = 0


@dataclass
class Trace:
    """The device's operations and the host's idle gaps in one window."""
    window_s: float
    device: list[Event]                 # clipped to the window
    idle: dict[str, float] = field(default_factory=dict)  # label -> s
    busy_s: float = 0.0

    def kernels(self) -> list[Event]:
        """Device operations other than copies and sets."""
        return [e for e in self.device if not e.name.startswith(_COPIES)]

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for e in self.device:
            out[short_name(e.name)] += (e.end - e.start) / 1e9
        return out

    def matching(self, kernels) -> tuple[int, float]:
        """(count, device seconds) of the operations named after any of
        `kernels` (a kernel's base name, without namespace or template)."""
        pat = kernel_pattern(kernels)
        if pat is None:
            return 0, 0.0
        seen: dict[str, bool] = {}
        hit = [e for e in self.device
               if seen.setdefault(e.name, bool(pat.search(e.name)))]
        return len(hit), sum(e.end - e.start for e in hit) / 1e9

    def breakdown(self) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:_TOP]],
                "idle_gaps": [[n, s] for n, s in gaps[:_TOP]]}


def kernel_pattern(kernels):
    """A regex that finds any of the kernel names in a demangled name."""
    kernels = list(kernels)
    if not kernels:
        return None
    alt = "|".join(re.escape(k) for k in kernels)
    return re.compile(rf"(?<![\w])(?:{alt})(?=\s*[<(]|$)")


def short_name(name: str) -> str:
    """A kernel's demangled name without `void`, the anonymous namespace
    and its parameter list, at most 120 characters."""
    s = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if s.endswith(")") and "(" in s and not s.startswith(_COPIES):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    return s[:120]


def union(intervals) -> list[tuple[int, int]]:
    """Merged [start, end) intervals, in order."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def host_segments(host: list[Event], w0: int, w1: int):
    """[(start, end, label)] covering [w0, w1): what the host thread was
    doing, as `<harness span> > <innermost event>`."""
    segs = []
    stack: list[Event] = []
    cursor = w0

    def label():
        outer = next((e.name for e in stack if e.name in (CALL, SYNC)),
                     "harness")
        inner = stack[-1].name if stack else "-"
        return outer if inner == outer else f"{outer} > {inner}"

    def emit(to):
        nonlocal cursor
        if to > cursor:
            segs.append((cursor, to, label()))
            cursor = to

    for e in sorted(host, key=lambda e: (e.start, -e.end)):
        if e.end <= w0 or e.start >= w1 or e.name == WINDOW:
            continue
        while stack and stack[-1].end <= e.start:
            emit(stack[-1].end)
            stack.pop()
        emit(max(e.start, w0))
        if stack:       # clip an event that outlives its parent
            e = Event(e.name, e.start, min(e.end, stack[-1].end), e.thread)
        stack.append(e)
    while stack:
        emit(min(stack[-1].end, w1))
        stack.pop()
    emit(w1)
    return segs


def attribute(gaps, segs) -> dict[str, float]:
    """Seconds of each gap, summed by the label of the host segments it
    overlaps (both lists in time order)."""
    out: dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b = max(g0, segs[k][0]), min(g1, segs[k][1])
            if b > a:
                out[segs[k][2]] += (b - a) / 1e9
            k += 1
    return dict(out)


def build(events: list[Event], device: list[Event]) -> Trace | None:
    """The Trace of the window span among host `events`; None without
    one."""
    win = next((e for e in events if e.name == WINDOW), None)
    if win is None:
        return None
    w0, w1 = win.start, win.end
    dev = [Event(e.name, max(e.start, w0), min(e.end, w1))
           for e in device if e.end > w0 and e.start < w1]
    busy = union((e.start, e.end) for e in dev)
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = [e for e in events if e.thread == win.thread]
    return Trace(window_s=(w1 - w0) / 1e9, device=dev,
                 idle=attribute(gaps, host_segments(host, w0, w1)),
                 busy_s=sum(b - a for a, b in busy) / 1e9)


def from_profiler(prof) -> Trace | None:
    """The Trace of a finished torch.profiler.profile. The spans that the
    profiler mirrors onto the device's timeline (user annotations) are no
    device work: a device event named as a host event is left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
        (device if e.device_type() == cuda else host).append(ev)
    host_names = {e.name for e in host}
    return build(host, [e for e in device if e.name not in host_names])
