"""orders JOIN lineitem ON o_orderkey = l_orderkey:
`lsdradixsort_tpu_torch.hash_join(o_orderkey, o_orderdate, l_orderkey,
l_extendedprice, engine)` with the traffic's engine, each call the same
tables. The answer
is (count, l_orderkey, l_extendedprice, o_orderdate) in lineitem order."""
from __future__ import annotations

import lsdradixsort_tpu_torch as lsd

from portbench import peaks

COLUMNS = ("o_orderkey", "o_orderdate", "l_orderkey", "l_extendedprice")


def prepare(data: dict, config: dict, traffic: dict) -> dict:
    return {**{c: data[c] for c in COLUMNS}, "engine": traffic["engine"]}


def args(state: dict, i: int) -> dict:
    return state


def call(a: dict):
    return lsd.hash_join(a["o_orderkey"], a["o_orderdate"], a["l_orderkey"],
                         a["l_extendedprice"], engine=a["engine"])


def work(a: dict) -> dict:
    nb, np_ = a["o_orderkey"].shape[0], a["l_orderkey"].shape[0]
    # read: two columns a side; written: the count and three probe columns;
    # sorted: key, packed position and value of every row of both sides
    return {"rows": nb + np_,
            "least_bytes": peaks.columns_bytes(nb + np_, 2)
            + peaks.columns_bytes(np_, 3) + peaks.WORD,
            "sort_rows": nb + np_, "sort_streams": 3}
