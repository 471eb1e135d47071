"""`lsdradixsort_tpu_torch.sort_kv(keys, vals)` on one row group of the
resident table a call, the row groups taken in turn, so that a call finds
none of its rows in the L2 cache."""
from __future__ import annotations

import lsdradixsort_tpu_torch as lsd

from portbench import peaks


def prepare(data: dict, config: dict, traffic: dict) -> dict:
    rows = int(traffic["rows_per_call"])
    return {"keys": data["keys"], "vals": data["vals"], "rows": rows,
            "groups": data["keys"].shape[0] // rows}


def args(state: dict, i: int) -> dict:
    rows = state["rows"]
    a = (i % state["groups"]) * rows
    return {"keys": state["keys"][a:a + rows],
            "vals": state["vals"][a:a + rows]}


def call(a: dict):
    return lsd.sort_kv(a["keys"], a["vals"])


def work(a: dict) -> dict:
    n = a["keys"].shape[0]
    # the payload rides beside the key and the row index the sort adds
    return {"rows": n, "least_bytes": 2 * peaks.columns_bytes(n, 2),
            "sort_rows": n, "sort_streams": 3}
