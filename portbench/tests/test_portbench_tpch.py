"""The TPC-H generator against the specification's rules (clause 4.2.3),
at SF 0.01 on the CPU."""
import datetime

import numpy as np
import pytest
import torch

from portbench import layout
from portbench.data import tpch

SF = 0.01
SEED = 2**31 + 77


def _np(t):
    return t.view(torch.int32).numpy().astype(np.int64)


@pytest.fixture(scope="module")
def data():
    cfg = {**layout.config("tpch_sf30"), "scale_factor": SF}
    return {k: _np(v) for k, v in tpch.make(cfg, {}, SEED, "cpu").items()}


def test_order_keys_are_the_first_8_of_every_32(data):
    ok = data["o_orderkey"]
    assert ok.shape[0] == int(SF * 1_500_000)
    assert np.all(np.diff(ok) > 0)
    assert set(np.unique((ok - 1) % 32)) == set(range(8))
    assert ok[-1] <= SF * 6_000_000


def test_one_to_seven_lines_an_order_in_key_order(data):
    lk = data["l_orderkey"]
    assert np.all(np.diff(lk) >= 0), "lineitem is clustered by order key"
    keys, counts = np.unique(lk, return_counts=True)
    assert np.array_equal(keys, data["o_orderkey"])
    assert counts.min() == 1 and counts.max() == 7
    assert abs(counts.mean() - 4) < 0.1


def test_quantity_price_and_dates(data):
    q, price = data["l_quantity"], data["l_extendedprice"]
    assert q.min() == 1 and q.max() == 50
    assert np.all(price % q == 0)
    retail = price // q
    assert retail.min() >= 90000 and retail.max() <= 90000 + 20000 + 99900
    od = data["o_orderdate"]
    assert od.min() >= 0 and od.max() <= tpch.END - 151
    lines = np.unique(data["l_orderkey"], return_counts=True)[1]
    ship_gap = data["l_shipdate"] - np.repeat(od, lines)
    assert ship_gap.min() == 1 and ship_gap.max() == 121


def test_returnflag_and_linestatus_rules(data):
    flag, status = data["l_group"] >> 8, data["l_group"] & 0xFF
    ship = data["l_shipdate"]
    assert set(np.unique(flag)) == {ord("R"), ord("A"), ord("N")}
    assert np.array_equal(status == ord("O"), ship > tpch.CURRENT)
    # receipt = ship + 1..30: after CURRENTDATE once ship is, before it
    # once ship + 30 is
    assert np.all(flag[ship > tpch.CURRENT] == ord("N"))
    assert np.all(flag[ship + 30 <= tpch.CURRENT] != ord("N"))
    assert set(np.unique(data["l_group"])) == {
        ord("A") * 256 + ord("F"), ord("N") * 256 + ord("F"),
        ord("N") * 256 + ord("O"), ord("R") * 256 + ord("F")}


def test_dates_and_q1_cutoff():
    assert tpch.day(1992, 1, 1) == 0
    assert tpch.END == (datetime.date(1998, 12, 31)
                        - datetime.date(1992, 1, 1)).days
    cutoff = datetime.date(1998, 12, 1) - datetime.timedelta(days=90)
    assert layout.config("tpch_sf30")["q1_shipdate_cutoff"] == tpch.day(
        cutoff.year, cutoff.month, cutoff.day)


def test_the_seed_decides_the_data():
    cfg = {**layout.config("tpch_sf30"), "scale_factor": 0.001}
    a = tpch.make(cfg, {}, SEED, "cpu")
    b = tpch.make(cfg, {}, SEED, "cpu")
    c = tpch.make(cfg, {}, SEED + 1, "cpu")
    assert all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in a)
    assert not torch.equal(a["l_quantity"].view(torch.int32)[:100],
                           c["l_quantity"].view(torch.int32)[:100])


def test_discount_in_hundredths(data):
    d = data["l_discount"]
    assert d.shape == data["l_orderkey"].shape
    assert d.min() == 0 and d.max() == 10
    assert abs(d.mean() - 5) < 0.1
