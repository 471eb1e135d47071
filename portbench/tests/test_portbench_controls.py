"""The check that decides `correct`, driven through the whole harness on
the CPU (the port's plain versions; the look for a card skipped): a
sound run comes out correct; the control (the reference one step below
the configuration's guarantee) and each fault planted under the timed
path come out not correct. On the card, `python3 -m portbench.control`
runs the control at each cell's own size."""
import time

import pytest
import torch

from portbench import layout, run

SEED = 2**31 + 9
TINY = {
    "lsd.keys.2e30": {"config": {"table_rows": 1 << 16}},
    "tpch30.join": {"config": {"scale_factor": 0.002}},
    "tpch30.q1": {"config": {"scale_factor": 0.002}},
}
# the control needs keys that float32 cannot tell apart (past 24 bits
# for the join: SF >= 3) and sums past 24 bits (Q1: SF >= 1)
CONTROL = {**TINY, "tpch30.join": {"config": {"scale_factor": 3}},
           "tpch30.q1": {"config": {"scale_factor": 1}}}


def _run(cell, overrides, call=None, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, False,
                        start=time.perf_counter(), device="cpu",
                        overrides=overrides, call=call)


def _entry(cell):
    return layout.module("entries", layout.workload(cell)["entry"])


def _flip(t, row=0):
    """t with one row's bits altered."""
    out = t.clone().view(torch.int32)
    out[row] ^= 1
    return out.view(t.dtype)


def _cat(a, b):
    return torch.cat([a.view(torch.int32), b.view(torch.int32)]).view(
        a.dtype)


def _half(a, cols):
    return {**a, **{c: a[c][:a[c].shape[0] // 2] for c in cols}}


# each fault, per entry: the call it puts in the timed path
FAULTS = {
    "sort_keys": {
        "unchanged": lambda e: lambda a: a["keys"],
        "half": lambda e: lambda a: _cat(
            e.call(_half(a, ["keys"])),
            a["keys"][a["keys"].shape[0] // 2:]),
        "altered": lambda e: lambda a: _flip(e.call(a)),
    },
    "hash_join": {
        "unchanged": lambda e: lambda a: (
            torch.tensor(a["l_orderkey"].shape[0]), a["l_orderkey"],
            a["l_extendedprice"], a["l_extendedprice"]),
        "half": lambda e: lambda a: e.call(
            _half(a, ["l_orderkey", "l_extendedprice"])),
        "altered": lambda e: lambda a: (lambda o: (*o[:3], _flip(o[3])))(
            e.call(a)),
    },
    "filtered_group_by_sum": {
        "unchanged": lambda e: lambda a: tuple(
            (torch.tensor(a["l_group"].shape[0]), a["l_group"], v)
            for v in a["values"].values()),
        "half": lambda e: lambda a: e.call(
            {**_half(a, ["l_shipdate", "l_group"]),
             "values": _half(a["values"], list(a["values"]))}),
        "altered": lambda e: lambda a: (
            lambda o: (*o[:-1], (*o[-1][:2], _flip(o[-1][2], 1))))(
            e.call(a)),
    },
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    r = _run(cell, TINY[cell])
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_control_is_not_correct(cell):
    ref = layout.module("reference", layout.workload(cell)["reference"])
    r = _run(cell, CONTROL[cell], call=ref.control, seconds=0.1)
    assert r["correct"] is False, r["checks"]
    assert any(c["value"] > 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    entry = _entry(cell)
    name = layout.workload(cell)["entry"]
    r = _run(cell, TINY[cell], call=FAULTS[name][fault](entry))
    assert r["correct"] is False, (fault, r["checks"])
