"""TPC-H Q1's filter, grouping and aggregates as an executor issues them
to this library, whose `filtered_group_by_sum` takes one value column:
one call `lsdradixsort_tpu_torch.filtered_group_by_sum(l_shipdate,
l_group, column, 0, cutoff + 1, engine)` for each SUM the traffic names
(`sum_columns`), and one more over a column of ones for COUNT(*)
(`count`), each call over the whole table. A call of the window is the
whole query: SELECT l_group, SUM(c) for each c, COUNT(*) WHERE
l_shipdate <= cutoff GROUP BY l_group ORDER BY l_group. The AVGs are
the sums over the count, four numbers an executor divides on the host.
The answer is one (count, group keys, sums) a column, in that order."""
from __future__ import annotations

import torch

import lsdradixsort_tpu_torch as lsd

from portbench import peaks

ONES = "ones"       # the column COUNT(*) sums


def prepare(data: dict, config: dict, traffic: dict) -> dict:
    columns = list(traffic["sum_columns"])
    values = {c: data[c] for c in columns}
    if traffic.get("count"):
        n = data["l_shipdate"].shape[0]
        values[ONES] = torch.ones(n, dtype=torch.int32,
                                  device=data["l_shipdate"].device
                                  ).view(torch.uint32)
    return {"l_shipdate": data["l_shipdate"], "l_group": data["l_group"],
            "values": values, "hi": int(config["q1_shipdate_cutoff"]) + 1,
            "groups": int(traffic["groups"]), "engine": traffic["engine"]}


def args(state: dict, i: int) -> dict:
    return state


def call(a: dict):
    return tuple(lsd.filtered_group_by_sum(a["l_shipdate"], a["l_group"], v,
                                           0, a["hi"], engine=a["engine"])
                 for v in a["values"].values())


def work(a: dict) -> dict:
    n = a["l_shipdate"].shape[0]
    k = len(a["values"])
    summed = sum(c != ONES for c in a["values"])
    # read: the date, the group and each summed column (COUNT(*) reads
    # none); written: the count and a key and k aggregates a group; each
    # of the k calls sorts group key, packed position and value
    return {"rows": n,
            "least_bytes": peaks.columns_bytes(n, 2 + summed)
            + peaks.columns_bytes(a["groups"], 1 + k) + peaks.WORD,
            "sort_rows": n, "sort_streams": 3}
