"""The port's spans and counters read beside the result line
(portbench/spans.py): device operations owned by the span of their
launch, idle time by span, the readings' arithmetic on synthetic kineto
events; the accepted per-layer metrics unchanged by the port's spans; a
traced run on the CPU, and on the card where there is one."""
import time

import pytest
import torch

from portbench import layout, run, spans as sp, trace as tr
from portbench.tests.test_portbench_card import SEED, SOUND
from portbench.tests.test_portbench_controls import TINY
from portbench.tests.test_portbench_metrics import _Kineto, _read, _window

MS = 1_000_000
KEYS = "void (anonymous namespace)::cluster_sort<1, 6>(W)"
MERGE = "void (anonymous namespace)::merge_tiles<1, false>(P)"
GLUE = "void at::native::vectorized_elementwise_kernel<4>(int)"
COPY = "Memcpy DtoH (Device -> Pinned)"


class _Launched(_Kineto):
    """A kineto event with the correlation id that pairs a device op
    with the runtime call that launched it."""

    def __init__(self, name, a, b, cuda=False, corr=0):
        super().__init__(name, a, b, cuda)
        self._corr = corr

    def correlation_id(self):
        return self._corr


def _profiler(events):
    return type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": lambda self: events})()
    })()})()


def _spanned(spans=True):
    """A 100 ms window with two calls of `lsd.sort`: a tile sort and a
    merge pass inside `lsd.merge_sort` and their kernel spans, then a
    glue op in `lsd.sort` alone, and a copy that the harness launches.
    With `spans`, the port's spans and their mirrors on the device are
    in; without, the same launches and device work alone."""
    ev = [_Launched(tr.WINDOW, 0, 100 * MS)]
    for c in (0, 50):
        b = c * MS
        ev += [_Launched(tr.CALL, b, b + 12 * MS),
               _Launched(tr.SYNC, b + 12 * MS, b + 50 * MS)]
        ops = [(KEYS, 1, 2, 12, 30), (MERGE, 3, 4, 30, 38),
               (GLUE, 6, 7, 38, 40)]
        for k, (name, l0, l1, d0, d1) in enumerate(ops):
            corr = c + k + 1
            ev += [_Launched("cudaLaunchKernel", b + l0 * MS, b + l1 * MS,
                             corr=corr),
                   _Launched(name, b + d0 * MS, b + d1 * MS, cuda=True,
                             corr=corr)]
        if spans:
            host = [("lsd.sort", 0.5, 11), ("lsd.merge_sort", 0.8, 5),
                    ("lsd.kernel.sort_tiles", 0.9, 2.5),
                    ("lsd.kernel.merge_pass_multi", 2.8, 4.5)]
            for name, a, z in host:
                ev += [_Launched(name, b + int(a * MS), b + int(z * MS)),
                       _Launched(name, b + 12 * MS, b + 40 * MS, cuda=True)]
    ev += [_Launched("cudaMemcpyAsync", 45 * MS, 46 * MS, corr=99),
           _Launched(COPY, 45 * MS, 47 * MS, cuda=True, corr=99)]
    return ev


def test_each_device_op_is_owned_by_the_spans_open_at_its_launch():
    r = sp.from_profiler(_profiler(_spanned()))
    assert r.opened == {"lsd.sort": 2, "lsd.merge_sort": 2,
                        "lsd.kernel.sort_tiles": 2,
                        "lsd.kernel.merge_pass_multi": 2}
    # the mirrored spans are no device work
    assert len(r.device) == 7
    owners = dict(zip(((e.name, e.start // MS) for e in r.device), r.owners))
    assert owners[(KEYS, 12)] == ("lsd.sort", "lsd.merge_sort",
                                  "lsd.kernel.sort_tiles")
    assert owners[(MERGE, 80)] == ("lsd.sort", "lsd.merge_sort",
                                   "lsd.kernel.merge_pass_multi")
    assert owners[(GLUE, 38)] == ("lsd.sort",)
    assert owners[(COPY, 45)] == ()
    # a device op whose launch is not in the trace has no owner
    lost = sp.read([sp.Op(tr.WINDOW, 0, 10)], [sp.Op("k", 1, 2, corr=5)])
    assert lost.owners == [()]
    assert sp.read([], []) is None


def test_idle_gaps_go_to_the_innermost_span_or_the_harness():
    r = sp.from_profiler(_profiler(_spanned()))
    # idle: 0-12 of each call, 40-45 and 47-50, 90-100
    assert r.idle == pytest.approx({
        "harness": 2 * 0.0005 + 2 * 0.001 + 0.005 + 0.003 + 0.010,
        "lsd.sort": 2 * (0.0003 + 0.006),
        "lsd.merge_sort": 2 * (0.0001 + 0.0003 + 0.0005),
        "lsd.kernel.sort_tiles": 2 * 0.0016,
        "lsd.kernel.merge_pass_multi": 2 * 0.0017})
    assert r.busy_s == pytest.approx(0.058)


def test_the_readings_arithmetic():
    s = sp.from_profiler(_profiler(_spanned())).summary(calls=2)
    t = s["spans"]
    assert t["lsd.sort"] == pytest.approx(
        {"per_call": 1.0, "device_ms": 2.0, "idle_ms": 6.3})
    assert t["lsd.kernel.sort_tiles"] == pytest.approx(
        {"per_call": 1.0, "device_ms": 18.0, "idle_ms": 1.6})
    assert t["lsd.merge_sort"]["device_ms"] == 0.0
    # everything but the harness's copy has an owner
    owned = sum(v["device_ms"] for v in t.values())
    assert owned == pytest.approx(1e3 * 0.058 / 2 - 1.0)
    assert s["owned_pct"] == pytest.approx(100 * 56 / 58)
    # the sort owns 2 × (18 + 8) of the 58 ms of device work
    assert s["sort_pct"] == pytest.approx(100 * 52 / 58)
    # the glue op in lsd.sort; the copy is in no span of the port
    assert s["glue_ms"] == pytest.approx(2.0)
    assert sp.from_profiler(_profiler(_spanned())).summary(0)["spans"] == {}


def test_without_the_ports_spans_nothing_is_owned():
    s = sp.from_profiler(_profiler(_spanned(spans=False))).summary(calls=2)
    assert s["spans"] == {}
    assert s["owned_pct"] == s["sort_pct"] == 0.0
    assert s["glue_ms"] == 0.0


def test_the_ports_spans_change_no_accepted_metric():
    """Every per-layer metric of BENCHMARK.json reads the same on a trace
    with the port's spans, and their mirrors on the device, as without."""
    with_spans = _window(tr.from_profiler(_profiler(_spanned())))
    without = _window(tr.from_profiler(_profiler(_spanned(spans=False))))
    assert len(with_spans.trace.device) == len(without.trace.device) == 7
    names = [m["name"] for m in layout.benchmark()["per_layer"]]
    assert len(names) == 11
    for name in names:
        assert _read(name, with_spans) == _read(name, without), name


def test_a_traced_run_on_the_cpu_reads_the_ports_spans_and_counters():
    """The plain versions, so no device events: Q1's four calls a query
    open four op spans, each reads one value on the host (its rows pad to
    a tile) and widens int64 columns. The result line is left as it
    was."""
    s = sp.measure("tpch30.q1", 2**31 + 9, 0.3, start=time.perf_counter(),
                   device="cpu", overrides=TINY["tpch30.q1"])
    assert s["correct"] is True
    t = s["spans"]
    assert t["lsd.filtered_group_by_sum"]["per_call"] == 4.0
    assert t["lsd.host_sync"]["per_call"] == 4.0
    for stage in ("mask", "sums", "bounds", "differences"):
        assert t[f"lsd.agg.{stage}"]["per_call"] == 4.0
    assert all(v["device_ms"] == 0.0 for v in t.values())
    assert not any(name.startswith(sp.KERNEL) for name in t)
    assert s["counters"]["host_syncs"] == 4.0
    assert s["counters"]["int64_bytes"] > 0
    assert s["owned_pct"] is None


def test_the_result_line_carries_no_spans():
    r = run.run_cell("tpch30.q1", 2**31 + 9, 0.2, True,
                     start=time.perf_counter(), device="cpu",
                     overrides=TINY["tpch30.q1"])
    assert "spans" not in r and "counters" not in r
    assert torch.profiler.profile.__name__ == "profile"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(SOUND))
def test_on_the_card_the_ports_spans_own_its_device_work(cell, card):
    s = sp.measure(cell, SEED, 0.5, start=time.perf_counter(), device=card,
                   overrides=SOUND[cell])
    assert s["correct"] is True
    assert any(name.startswith(sp.KERNEL) for name in s["spans"])
    owned_ms = sum(v["device_ms"] for v in s["spans"].values())
    busy_ms = 1e3 * s["busy_s"] / s["attempted"]
    assert abs(owned_ms - busy_ms) <= 0.005 * busy_ms, (owned_ms, busy_ms)
    assert s["owned_pct"] >= 99.5
