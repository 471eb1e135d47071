"""The port's benchmark CLI (lsdradixsort_tpu_torch/bench/runner.py) on the
CPU: every suite end to end with --verify semantics at 2^16 rows on CPU
tensors (the kernels' plain versions), with and without --sweep, with
the runner's CUDA-event timer patched to the host timer; its suites,
records and configs against the JAX runner's; the report files and the
exit rule of `main`; and the torch.profiler trace of core/profiling.py."""
import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from lsdradixsort_tpu.bench import runner as jax_runner
from lsdradixsort_tpu.core import timing as jax_timing
from lsdradixsort_tpu_torch.bench import runner
from lsdradixsort_tpu_torch.core import profiling
from lsdradixsort_tpu_torch.core.timing import time_host


def _host_timer(fn, *args, iters=5):
    return time_host(fn, *args, iters=1)


@pytest.fixture
def on_cpu(monkeypatch):
    """The runner timed on the host clock, with a stub card label; the
    world of one that the dist suite makes in this process is torn down
    after the test."""
    monkeypatch.setattr(runner, "time_fn", _host_timer)
    monkeypatch.setattr(runner, "card_label", lambda: "stub card, 0.00 W")
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("suite", list(runner.SUITES))
def test_suite_runs_and_verifies(on_cpu, suite, sweep):
    records = runner.SUITES[suite](16, verify=True, sweep=sweep,
                                   device="cpu")
    assert records, f"suite {suite} produced no records"
    for rec in records:
        assert rec.verified is True, rec.line()
        assert rec.device_ms > 0
    if suite == "dist":     # a world of one: the overhead, not scaling
        assert records[0].config["devices"] == 1
        assert records[0].config["d1_dist_overhead"] > 0


def test_suites_and_record_match_the_jax_runner():
    assert list(runner.SUITES) == list(jax_runner.SUITES)
    assert ([f.name for f in dataclasses.fields(runner.Record)]
            == [f.name for f in dataclasses.fields(jax_runner.Record)])


@pytest.mark.parametrize("suite", ["shuffle", "histogram", "scan",
                                   "transpose"])
def test_configs_match_the_jax_runner(on_cpu, monkeypatch, suite):
    monkeypatch.setattr(jax_runner, "time_fn", lambda fn, *a, iters=10:
                        jax_timing.time_host(fn, *a, iters=1))
    want = [(r.suite, r.config, r.verified)
            for r in jax_runner.SUITES[suite](16, verify=True, sweep=False)]
    got = [(r.suite, r.config, r.verified)
           for r in runner.SUITES[suite](16, verify=True, sweep=False,
                                         device="cpu")]
    assert got == want


def test_main_writes_reports(on_cpu, tmp_path):
    out = tmp_path / "report"
    assert runner.main(["shuffle", "--n", "16", "--verify", "--out",
                        str(out), "--no-cache"], device="cpu") == 0
    rep = json.loads(out.with_suffix(".json").read_text())
    assert rep["card"] == "stub card, 0.00 W" and not rep["failed_suites"]
    assert [r["config"]["run_rows"] for r in rep["records"]] == [32, 128]
    assert all(r["verified"] for r in rep["records"])
    md = out.with_suffix(".md").read_text()
    assert "stub card" in md and md.count("verified") == 2


def test_main_exit_code(on_cpu, monkeypatch):
    bad = runner.Record(suite="shuffle", config={}, device_ms=1.0,
                        melems_per_s=1.0, gbytes_per_s=1.0,
                        roofline_frac=0.1, verified=False)
    monkeypatch.setitem(runner.SUITES, "shuffle", lambda *a, **k: [bad])
    assert runner.main(["shuffle"], device="cpu") == 1

    def crash(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setitem(runner.SUITES, "shuffle", crash)
    assert runner.run_suite("shuffle", 16, device="cpu")[1] == [
        {"suite": "shuffle", "error": "boom"}]
    assert runner.main(["shuffle"], device="cpu") == 1


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert runner.main(["shuffle", "--n", "16"]) == 1


def test_profiling_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("step"):
            torch.arange(1 << 12).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert files and '"step"' in files[0].read_text()
    lines = []
    with profiling.stopwatch("x", sink=lines.append):
        pass
    assert lines[0].startswith("[stopwatch] x: ")
