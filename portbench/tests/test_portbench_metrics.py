"""The trace reading, the byte counts and the metric readers, on
synthetic traces: no card is needed to check the arithmetic."""
import pytest
import torch

from portbench import layout, peaks, trace as tr
from portbench.run import Window

H100 = "NVIDIA H100 80GB HBM3"


def _ev(name, a, b, thread=1):
    return tr.Event(name, a, b, thread)


def _trace():
    """A 100-unit window (ns ×1e6 so the numbers read as ms): two calls,
    each a cluster_sort, a merge pass and a library gather."""
    ms = 1_000_000
    host = [_ev(tr.WINDOW, 0, 100 * ms),
            _ev(tr.CALL, 0, 10 * ms), _ev("aten::cat", 2 * ms, 4 * ms),
            _ev(tr.SYNC, 10 * ms, 50 * ms),
            _ev(tr.CALL, 50 * ms, 60 * ms), _ev(tr.SYNC, 60 * ms, 100 * ms),
            _ev("elsewhere", 0, 100 * ms, thread=2)]
    dev = [_ev("void (anonymous namespace)::cluster_sort<1, 6>(Words, "
               "Riders, Steps, Shape)", 5 * ms, 25 * ms),
           _ev("void (anonymous namespace)::merge_tiles<1, false>(P, int, "
               "int const*)", 25 * ms, 35 * ms),
           _ev("void (anonymous namespace)::merge_splits<1>(P, long long, "
               "int*)", 35 * ms, 40 * ms),
           _ev("void at::native::index_elementwise_kernel<128, 4>(long)",
               40 * ms, 45 * ms),
           _ev("void (anonymous namespace)::cluster_sort<1, 6>(Words, "
               "Riders, Steps, Shape)", 55 * ms, 75 * ms),
           _ev("void (anonymous namespace)::merge_tiles<1, false>(P, int, "
               "int const*)", 75 * ms, 85 * ms),
           _ev("Memcpy DtoD (Device -> Device)", 85 * ms, 95 * ms),
           _ev("before the window", -20 * ms, -10 * ms)]
    return tr.build(host, dev)


def test_busy_idle_and_gaps_by_host_activity():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.08)
    # idle: 0-5 (call: 0-2 python, 2-4 cat, 4-5 python), 45-50 (sync),
    # 50-55 (call), 95-100 (sync)
    assert t.idle == pytest.approx({
        "portbench.call": 0.003 + 0.005, "portbench.call > aten::cat": 0.002,
        "portbench.sync": 0.010})
    assert len(t.kernels()) == 6
    b = t.breakdown()
    assert b["device_ops"][0] == ["cluster_sort<1, 6>", pytest.approx(0.04)]
    assert b["idle_gaps"][0][0] == "portbench.sync"


def test_kernel_names_match_whole_names():
    t = _trace()
    assert t.matching(["cluster_sort"]) == (2, pytest.approx(0.04))
    assert t.matching(["merge_tiles", "merge_splits", "coarse_splits"]) \
        == (3, pytest.approx(0.025))
    assert t.matching(["merge"])[0] == 0
    pat = tr.kernel_pattern(["seg_scan"])
    assert pat.search("void (anonymous namespace)::seg_scan(unsigned int)")
    assert not pat.search("void (anonymous namespace)::seg_scan_regs(uint4)")


def _window(trace, calls=2, kind=H100):
    return Window(calls=calls, seconds=0.1, latencies=[0.05, 0.05],
                  setup_s=3.0,
                  work={"rows": 1 << 30, "least_bytes": 8 << 30,
                        "sort_rows": 1 << 30, "sort_streams": 1},
                  kind=kind, trace=trace,
                  kernel_names=layout.kernel_names())


def _read(name, w):
    return layout.metric_reader(name).read(w)


def test_readers_on_a_trace():
    w = _window(_trace())
    assert _read("device.idle_share.sort", w) == pytest.approx(20.0)
    assert _read("device.kernels_per_call.sort", w) == pytest.approx(3.0)
    least = (8 << 30) / 3.35e12
    assert _read("ops_roofline.sort", w) == pytest.approx(
        100 * least / 0.04)
    assert _read("sort_tiles_roofline.sort", w) == pytest.approx(
        100 * 2 * least / 0.04)
    assert _read("merge_pass_roofline.query", w) == pytest.approx(
        100 * 2 * least / 0.025)
    # the gather and the copy: 15 ms over 2 calls
    assert _read("glue.ms.sort", w) == pytest.approx(7.5)
    assert _read("sort_mrows_s", w) == pytest.approx(2 * 1024**3 / 0.1 / 1e6)
    assert _read("query_p95_ms", w) == pytest.approx(50.0)
    assert _read("setup_s", w) == 3.0


def test_readers_without_a_trace_or_a_known_card_read_nothing():
    untraced = _window(None)
    cpu = _window(_trace(), kind="cpu")
    for name in ("device.idle_share.sort", "device.kernels_per_call.sort",
                 "ops_roofline.sort", "sort_tiles_roofline.sort",
                 "merge_pass_roofline.sort", "glue.ms.query"):
        assert _read(name, untraced) is None
    for name in ("ops_roofline.sort", "sort_tiles_roofline.query",
                 "merge_pass_roofline.sort"):
        assert _read(name, cpu) is None
    empty = _window(tr.build([_ev(tr.WINDOW, 0, 10)], []))
    for name in ("device.idle_share.sort", "ops_roofline.query",
                 "glue.ms.sort", "sort_tiles_roofline.sort"):
        assert _read(name, empty) is None


def test_glue_reads_nought_where_only_the_ports_kernels_ran():
    ms = 1_000_000
    t = tr.build([_ev(tr.WINDOW, 0, 100 * ms)],
                 [_ev("void (anonymous namespace)::cluster_sort<1, 6>(W)",
                      5 * ms, 25 * ms),
                  _ev("void (anonymous namespace)::merge_tiles<1, false>(P)",
                      25 * ms, 35 * ms)])
    assert _read("glue.ms.sort", _window(t)) == 0.0


@pytest.mark.parametrize("name, stem", [
    ("sort_mrows_s", "mrows_s"), ("query_mrows_s", "mrows_s"),
    ("sort_p95_ms", "p95_ms"), ("query_p95_ms", "p95_ms"),
    ("glue.ms.query", "glue.ms"), ("ops_roofline.sort", "ops_roofline"),
    ("sort_tiles_roofline.query", "sort_tiles_roofline"),
    ("setup_s", "setup_s")])
def test_a_metric_finds_its_reader_by_name(name, stem):
    assert layout.metric_file(name).name == f"{stem}.py"


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        layout.metric_file("nothing_here.sort")


def test_percentile_is_nearest_rank():
    w = _window(None)
    w.latencies = [float(i) for i in range(1, 101)]
    assert w.percentile(95) == 95.0
    w.latencies = [float(i) for i in range(1, 21)]
    assert w.percentile(95) == 19.0
    w.latencies = [3.0]
    assert w.percentile(95) == 3.0


def test_byte_counts():
    assert peaks.stream_pass_bytes(1 << 30, 1) == 8 << 30
    assert peaks.stream_pass_bytes(10, 3) == 240
    assert peaks.columns_bytes(5, 2) == 40
    assert peaks.hbm_bytes_per_s(H100) == 3.35e12
    assert peaks.hbm_bytes_per_s("NVIDIA H100 PCIe") is None
    assert peaks.hbm_bytes_per_s("cpu") is None


def _u32(n):
    return torch.zeros(n, dtype=torch.int32).view(torch.uint32)


def test_entries_count_their_work():
    from portbench.entries import (filtered_group_by_sum, hash_join,
                                   sort_keys, sort_kv)
    assert sort_keys.work({"keys": _u32(1000)}) == {
        "rows": 1000, "least_bytes": 8000, "sort_rows": 1000,
        "sort_streams": 1}
    assert sort_kv.work({"keys": _u32(1000), "vals": _u32(1000)}) == {
        "rows": 1000, "least_bytes": 16000, "sort_rows": 1000,
        "sort_streams": 3}
    j = hash_join.work({"o_orderkey": _u32(10), "o_orderdate": _u32(10),
                        "l_orderkey": _u32(40), "l_extendedprice": _u32(40)})
    assert j == {"rows": 50, "least_bytes": 8 * 50 + 12 * 40 + 4,
                 "sort_rows": 50, "sort_streams": 3}
    q = filtered_group_by_sum.work({
        "l_shipdate": _u32(100), "groups": 4,
        "values": {c: _u32(100) for c in ("l_quantity", "l_extendedprice",
                                          "l_discount", "ones")}})
    # date, group and three summed columns read; a key and 4 aggregates
    # written a group, and the count
    assert q == {"rows": 100, "least_bytes": 2000 + 80 + 4,
                 "sort_rows": 100, "sort_streams": 3}


class _Kineto:
    """A kineto event as torch.profiler's results hand it out."""

    def __init__(self, name, a, b, cuda=False):
        self._e = (name, a, b, cuda)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def end_ns(self):
        return self._e[2]

    def start_thread_id(self):
        return 7

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._e[3]
                else torch.autograd.DeviceType.CPU)


def test_the_spans_mirrored_on_the_device_are_no_device_work():
    events = [_Kineto(tr.WINDOW, 0, 100), _Kineto(tr.CALL, 0, 90),
              _Kineto(tr.CALL, 5, 85, cuda=True),
              _Kineto("void (anonymous namespace)::cluster_sort<1, 6>(W)",
                      10, 60, cuda=True)]
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": lambda self: events})()
    })()})()
    t = tr.from_profiler(prof)
    assert [e.name for e in t.device] == [events[3].name()]
    assert t.busy_s == pytest.approx(50e-9)
