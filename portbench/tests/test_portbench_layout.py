"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, and a cell added by files alone."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import layout

BENCH = layout.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_are_found_and_state_their_cuts():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["why"])
        assert _line(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        spec = layout.config(c["name"])
        assert spec["name"] == c["name"]
        assert spec["reduced"] == c["reduced"]
        assert all(k in spec for k in c["reduced"])
        assert all(k in spec["source_values"] for k in c["reduced"])
        layout.module("data", spec["generator"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_are_found_by_name():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        layout.traffic(w["traffic"])
        cell = layout.workload(w["name"])
        entry = layout.module("entries", cell["entry"])
        ref = layout.module("reference", cell["reference"])
        for fn in ("prepare", "args", "call", "work"):
            assert callable(getattr(entry, fn))
        for fn in ("expect", "control", "compare"):
            assert callable(getattr(ref, fn))
        assert cell["check_calls"] >= 1 and cell["warmup_calls"] >= 1
        assert all(v == 0 for v in cell["limits"].values())


def test_metrics_have_readers_units_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        layout.metric_reader(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = layout.metrics_for(BENCH, cell, traced=False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert layout.metrics_for(BENCH, cell, traced=True)
    perf = (layout.CHECKOUT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, f"PERF.md lists no layer {layer!r}"


def test_every_port_kernel_has_a_name_file():
    csrc = layout.CHECKOUT / "lsdradixsort_tpu_torch" / "csrc"
    if not csrc.exists():
        pytest.skip("no port sources beside the benchmark")
    names = layout.kernel_names()
    for src in csrc.glob("*.cu"):
        assert (layout.HERE / "kernel_names" / f"{src.stem}.json").exists()
        text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "",
                      src.read_text())
        for k in re.findall(r"__global__\s+void\s+(\w+)\s*\(", text):
            assert k in names["kernels"], f"{src.name}: {k}"
    for fn in names["functions"].values():
        assert fn["launch"] in fn["kernels"]
        assert set(fn["kernels"]) <= set(names["kernels"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    cell as new files and a BENCHMARK.json entry, and runs the cell on
    the CPU: no existing file of portbench/ changes."""
    root = tmp_path / "checkout"
    shutil.copytree(layout.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = layout.config("lsd_u32_2e30")
    cfg.update(name="lsd_u32_tiny", table_rows=1 << 16)
    (root / "portbench/configs/lsd_u32_tiny.json").write_text(
        json.dumps(cfg))
    (root / "portbench/traffic/tiny_groups.json").write_text(json.dumps(
        {"rows_per_call": 3000, "payload": "u32 row index"}))
    (root / "portbench/workloads/lsd.kv.tiny.json").write_text(json.dumps(
        {"entry": "sort_kv", "reference": "sort_kv", "warmup_calls": 2,
         "check_calls": 4, "limits": {"key_mismatches": 0,
                                      "payload_mismatches": 0}}))
    bench["configs"].append({"name": "lsd_u32_tiny", "source": "test",
                             "file": "portbench/configs/lsd_u32_tiny.json",
                             "reduced": ["table_rows"], "why": "test"})
    bench["workloads"].append({"name": "lsd.kv.tiny", "config":
                               "lsd_u32_tiny", "traffic": "tiny_groups",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lsd.keys.2e30" in m.get("workloads", []):
            m["workloads"].append("lsd.kv.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time; from portbench import run; "
            "r = run.run_cell('lsd.kv.tiny', 2**31 + 3, 0.5, False, "
            "start=time.perf_counter(), device='cpu'); print(json.dumps(r))")
    env_path = str(layout.CHECKOUT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": env_path, "PATH": "/usr/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"sort_mrows_s", "sort_p95_ms",
                                      "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_the_command_needs_the_port(tmp_path):
    """Without the port beside it the command exits non-zero and prints
    no result."""
    shutil.copytree(layout.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(layout.CHECKOUT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload",
         "lsd.keys.2e30", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
