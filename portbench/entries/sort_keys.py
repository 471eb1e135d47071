"""`lsdradixsort_tpu_torch.sort(keys, strategy)` (the traffic's strategy;
"merge": the tile sort and the 8-way merge passes) on the whole resident table, each call the same."""
from __future__ import annotations

import lsdradixsort_tpu_torch as lsd

from portbench import peaks


def prepare(data: dict, config: dict, traffic: dict) -> dict:
    return {"keys": data["keys"], "strategy": traffic["strategy"]}


def args(state: dict, i: int) -> dict:
    return state


def call(a: dict):
    return lsd.sort(a["keys"], strategy=a["strategy"])


def work(a: dict) -> dict:
    n = a["keys"].shape[0]
    return {"rows": n, "least_bytes": 2 * peaks.columns_bytes(n, 1),
            "sort_rows": n, "sort_streams": 1}
