"""`lsdradixsort_tpu_torch.sort_records(records, key_bytes, strategy)` of
the whole resident file of fixed-width records (the traffic's strategy;
"merge": the key bytes as u32 words, one stable tile sort and 8-way merge
chain a word, least significant first, then one gather of whole rows),
each call the same file. The answer is a new (n, R) uint8 tensor."""
from __future__ import annotations

from lsdradixsort_tpu_torch import sort_records


def prepare(data: dict, config: dict, traffic: dict) -> dict:
    return {"records": data["records"], "key_bytes": int(config["key_bytes"]),
            "strategy": traffic["strategy"]}


def args(state: dict, i: int) -> dict:
    return state


def call(a: dict):
    return sort_records(a["records"], a["key_bytes"], strategy=a["strategy"])


def work(a: dict) -> dict:
    n, width = a["records"].shape
    # read and written: every record once; sorted: a key word, the running
    # position, the permutation and the other key words ride in each pass
    return {"rows": n, "least_bytes": 2 * n * width, "sort_rows": n,
            "sort_streams": -(-a["key_bytes"] // 4) + 2,
            "record_bytes": width}
