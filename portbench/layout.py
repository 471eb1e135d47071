"""Where the benchmark's files are: each found by the name that
BENCHMARK.json, a cell or a configuration gives it."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent          # portbench/
CHECKOUT = HERE.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return _json(CHECKOUT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{_checked(name)}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{_checked(name)}.json")


def module(kind: str, name: str) -> ModuleType:
    """portbench/<kind>/<name>.py: a data generator, an entry or a
    reference (names that are Python identifiers)."""
    if not _checked(name).isidentifier():
        raise ValueError(f"{kind} module names are identifiers: {name!r}")
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_file(name: str) -> Path:
    """metrics/<name>.py, else metrics/<name less its last dot-part>.py,
    else metrics/<name less its first _-part>.py: `glue.ms.sort` and
    `glue.ms.query` share metrics/glue.ms.py, `sort_mrows_s` and
    `query_mrows_s` metrics/mrows_s.py."""
    tries = [_checked(name)]
    if "." in name:
        tries.append(name.rsplit(".", 1)[0])
    if "_" in name:
        tries.append(name.split("_", 1)[1])
    for stem in tries:
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{HERE / 'metrics'}")


def metric_reader(name: str) -> ModuleType:
    """The module that reads metric `name` (its `read(window)`)."""
    path = metric_file(name)
    modname = "portbench.metrics._" + re.sub(r"\W", "_", path.stem)
    mod = sys.modules.get(modname)
    if mod is None:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return mod


def kernel_names() -> dict:
    """Every kernel_names/<source>.json: {"kernels": [names of the port's
    own kernels], "functions": {function: {"kernels": [...], "launch":
    name}}}, merged over the sources."""
    kernels, functions = [], {}
    for path in sorted((HERE / "kernel_names").glob("*.json")):
        spec = _json(path)
        kernels += spec.get("kernels", [])
        functions.update(spec.get("functions", {}))
    return {"kernels": kernels, "functions": functions}


def cell_entry(bench: dict, cell: str) -> dict:
    """The cell's entry in BENCHMARK.json's workloads."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or
    with a trace its per-layer ones. A metric with a `workloads` list
    is reported in those cells; an end-to-end metric without one in
    every cell, a per-layer metric without one in every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
