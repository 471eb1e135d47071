"""The two cells of the Sort Benchmark configuration and the xla join
(`sortbench.indy.10gb`, `tpch30.join.xla`) through the whole harness on
the CPU (the port's plain versions): a sound run is correct; the control
and each fault of test_portbench_controls.py planted under the timed path
are not; the gather's roofline share reads right on a synthetic trace;
the port's record spans and counter read right on a traced CPU run, and
on the card where there is one."""
import time

import pytest
import torch

from portbench import layout, run, spans as sp, trace as tr
from portbench.run import Window
from portbench.tests.test_portbench_controls import FAULTS, _run

SEED = 2**31 + 11
TINY = {
    "sortbench.indy.10gb": {"config": {"records": 3000}},
    "tpch30.join.xla": {"config": {"scale_factor": 0.002}},
}
# the control needs 10-byte keys that share their first 4 bytes: about
# 2^20 uniform keys make 128 such pairs; the join's as its merge cell's
CONTROL = {"sortbench.indy.10gb": {"config": {"records": 1 << 20}},
           "tpch30.join.xla": {"config": {"scale_factor": 3}}}
ON_CARD = {"sortbench.indy.10gb": {"config": {"records": 1 << 22}},
           "tpch30.join.xla": {"config": {"scale_factor": 1}}}
H100 = "NVIDIA H100 80GB HBM3"
GATHER = ("void (anonymous namespace)::gather_records<unsigned int>("
          "unsigned int const*, unsigned int const*, unsigned int*, long "
          "long, int)")


def _altered(out):
    out = out.clone()
    out[0, 0] ^= 1
    return out


RECORD_FAULTS = {
    "unchanged": lambda e: lambda a: a["records"],
    "half": lambda e: lambda a: e.call(
        {**a, "records": a["records"][:a["records"].shape[0] // 2]}),
    "altered": lambda e: lambda a: _altered(e.call(a)),
}


def _faults(cell):
    name = layout.workload(cell)["entry"]
    return RECORD_FAULTS if name == "sort_records" else FAULTS[name]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    r = _run(cell, TINY[cell])
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    names = {m["name"] for m in
             layout.metrics_for(layout.benchmark(), cell, traced=False)}
    assert set(r["metrics"]) == names


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_control_is_not_correct(cell):
    ref = layout.module("reference", layout.workload(cell)["reference"])
    r = _run(cell, CONTROL[cell], call=ref.control, seconds=0.1)
    assert r["correct"] is False, r["checks"]
    assert any(c["value"] > 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    entry = layout.module("entries", layout.workload(cell)["entry"])
    r = _run(cell, TINY[cell], call=_faults(cell)[fault](entry))
    assert r["correct"] is False, (fault, r["checks"])


def _window(device, work, kind=H100, calls=2):
    ms = 1_000_000
    t = tr.build([tr.Event(tr.WINDOW, 0, 100 * ms, 1)],
                 [tr.Event(name, a * ms, b * ms) for name, a, b in device])
    return Window(calls=calls, seconds=0.1, latencies=[0.05] * calls,
                  setup_s=1.0, work=work, kind=kind, trace=t,
                  kernel_names=layout.kernel_names())


def test_the_gathers_roofline_share():
    read = layout.metric_reader("gather_records_roofline.sort").read
    work = {"rows": 10**8, "least_bytes": 2 * 10**10, "sort_rows": 10**8,
            "sort_streams": 5, "record_bytes": 100}
    # two launches of 8 ms each: 2 x 10^8 x 204 bytes over 16 ms
    ops = [(GATHER, 10, 18), ("void at::native::index_elementwise_kernel"
                              "<128, 4>(long)", 18, 20), (GATHER, 60, 68)]
    w = _window(ops, work)
    assert read(w) == pytest.approx(100 * 2 * 10**8 * 204 / 3.35e12 / 0.016)
    # nothing to read: no record width, no launch, no trace, no known card
    assert read(_window(ops, {**work, "record_bytes": 0})) is None
    assert read(_window(ops[1:2], work)) is None
    assert read(_window(ops, {k: v for k, v in work.items()
                              if k != "record_bytes"})) is None
    assert read(_window(ops, work, kind="cpu")) is None
    untraced = _window(ops, work)
    untraced.trace = None
    assert read(untraced) is None
    # the gather is one of the port's kernels, no glue
    glue = layout.metric_reader("glue.ms.sort").read(w)
    assert glue == pytest.approx(1.0)


def test_the_new_cells_report_their_metrics_when_traced():
    bench = layout.benchmark()
    traced = {m["name"] for m in
              layout.metrics_for(bench, "sortbench.indy.10gb", traced=True)}
    assert traced == {"device.idle_share.sort", "device.kernels_per_call.sort",
                      "ops_roofline.sort", "sort_tiles_roofline.sort",
                      "merge_pass_roofline.sort", "glue.ms.sort",
                      "gather_records_roofline.sort"}
    traced = {m["name"] for m in
              layout.metrics_for(bench, "tpch30.join.xla", traced=True)}
    assert traced == {"device.idle_share.query", "ops_roofline.query",
                      "glue.ms.query"}


def test_a_traced_run_on_the_cpu_reads_the_record_spans_and_counter():
    s = sp.measure("sortbench.indy.10gb", SEED, 0.3,
                   start=time.perf_counter(), device="cpu",
                   overrides=TINY["sortbench.indy.10gb"])
    assert s["correct"] is True
    t = s["spans"]
    assert t["lsd.sort_records"]["per_call"] == 1.0
    for stage in ("keys", "sort", "gather"):
        assert t[f"lsd.records.{stage}"]["per_call"] == 1.0
    assert t["lsd.merge_sort"]["per_call"] == 3.0
    assert s["counters"]["record_bytes"] == 3000 * 100
    assert s["counters"]["host_syncs"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(ON_CARD))
def test_on_the_card_a_sound_run_is_correct_and_its_control_not(cell, card):
    r = run.run_cell(cell, SEED, 0.5, False, start=time.perf_counter(),
                     device=card, overrides=ON_CARD[cell])
    assert r["correct"] is True, r["checks"]
    ref = layout.module("reference", layout.workload(cell)["reference"])
    r = run.run_cell(cell, SEED, 0.5, False, start=time.perf_counter(),
                     device=card, overrides=CONTROL[cell], call=ref.control)
    assert r["correct"] is False, r["checks"]


def test_on_the_card_the_record_spans_own_the_device_work(card):
    cell = "sortbench.indy.10gb"
    s = sp.measure(cell, SEED, 0.5, start=time.perf_counter(), device=card,
                   overrides=ON_CARD[cell])
    assert s["correct"] is True
    assert s["spans"]["lsd.kernel.gather_records"]["per_call"] == 1.0
    assert s["counters"]["record_bytes"] == (1 << 22) * 100
    assert s["owned_pct"] >= 99.5
