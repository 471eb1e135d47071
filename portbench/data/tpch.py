"""TPC-H `orders` and `lineitem`, the columns Q1 and the orders-lineitem
join read, generated on the device from the seed by the rules of the
TPC-H specification (v3, clause 4.2.3):

  o_orderkey       sparse: the first 8 keys of every 32, SF * 1.5 M orders
  o_orderdate      uniform over [STARTDATE, ENDDATE - 151 days]
  lines per order  uniform over 1..7; lineitem in generation order,
                   clustered by order key, as dbgen writes it
  l_quantity       uniform over 1..50
  l_extendedprice  l_quantity * p_retailprice of a uniform part key in
                   [1, SF * 200,000], in cents: 90000 + (pk / 10) mod 20001
                   + 100 * (pk mod 1000)
  l_shipdate       o_orderdate + uniform 1..121 days
  l_receiptdate    l_shipdate + uniform 1..30 days
  l_returnflag     R or A at random where l_receiptdate <= CURRENTDATE,
                   else N
  l_linestatus     O where l_shipdate > CURRENTDATE, else F
  l_discount       uniform over 0.00..0.10, in hundredths (0..10); drawn
                   last, so the other columns do not depend on it

Dates are u32 day numbers from STARTDATE = 1992-01-01; CURRENTDATE is
1995-06-17 and ENDDATE 1998-12-31. `l_group` is (l_returnflag << 8) |
l_linestatus, whose order is Q1's ORDER BY. Every column is u32.
"""
from __future__ import annotations

import datetime

import torch

START = datetime.date(1992, 1, 1)


def day(y: int, m: int, d: int) -> int:
    """The day number of a date."""
    return (datetime.date(y, m, d) - START).days


CURRENT = day(1995, 6, 17)
END = day(1998, 12, 31)
ORDERS_PER_SF = 1_500_000
PARTS_PER_SF = 200_000


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.uint32)


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    sf = float(config["scale_factor"])
    n_o = int(round(sf * ORDERS_PER_SF))
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))

    def draw(lo: int, hi: int, n: int) -> torch.Tensor:
        """n uniform int32 in [lo, hi]."""
        return torch.randint(lo, hi + 1, (n,), dtype=torch.int32,
                             device=device, generator=g)

    i = torch.arange(n_o, dtype=torch.int32, device=device)
    o_orderkey = (i // 8) * 32 + (i % 8) + 1
    o_orderdate = draw(0, END - 151, n_o)
    lines = draw(1, 7, n_o).to(torch.int64)
    l_orderkey = torch.repeat_interleave(o_orderkey, lines)
    l_shipdate = torch.repeat_interleave(o_orderdate, lines)
    del i, lines
    n_l = l_orderkey.shape[0]
    l_quantity = draw(1, 50, n_l)
    pk = draw(1, int(round(sf * PARTS_PER_SF)), n_l)
    l_extendedprice = l_quantity * (90000 + (pk // 10) % 20001
                                    + 100 * (pk % 1000))
    del pk
    l_shipdate += draw(1, 121, n_l)
    receipt = l_shipdate + draw(1, 30, n_l)
    flag = torch.where(receipt <= CURRENT,
                       torch.where(draw(0, 1, n_l) == 0, ord("R"), ord("A")),
                       ord("N"))
    del receipt
    status = torch.where(l_shipdate > CURRENT, ord("O"), ord("F"))
    l_group = flag * 256 + status
    del flag, status
    l_discount = draw(0, 10, n_l)
    return {"o_orderkey": _u32(o_orderkey), "o_orderdate": _u32(o_orderdate),
            "l_orderkey": _u32(l_orderkey),
            "l_extendedprice": _u32(l_extendedprice),
            "l_quantity": _u32(l_quantity), "l_shipdate": _u32(l_shipdate),
            "l_group": _u32(l_group), "l_discount": _u32(l_discount)}
