"""(keys, values) sorted by key ascending as unsigned 32-bit integers,
stably: equal keys keep their values in input order."""
from __future__ import annotations

from portbench.reference._u32 import (ascending_order, float_order,
                                      rows_differ, take)


def expect(a: dict):
    order = ascending_order(a["keys"], stable=True)
    return take(a["keys"], order), take(a["vals"], order)


def control(a: dict):
    """The keys compared as float32, which cannot tell apart keys closer
    than its step."""
    order = float_order(a["keys"])
    return take(a["keys"], order), take(a["vals"], order)


def compare(got, want) -> dict:
    n = want[0].shape[0]
    return {"key_mismatches": rows_differ([got[0]], [want[0]], n),
            "payload_mismatches": rows_differ([got[1]], [want[1]], n)}
