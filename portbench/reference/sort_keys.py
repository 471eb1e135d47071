"""The keys sorted ascending as unsigned 32-bit integers, exactly."""
from __future__ import annotations

import torch

from portbench.reference._u32 import (SIGN, float_order, rows_differ,
                                      take)


def expect(a: dict) -> torch.Tensor:
    k = a["keys"].view(torch.int32) ^ SIGN
    return (torch.sort(k).values ^ SIGN).view(torch.uint32)


def control(a: dict) -> torch.Tensor:
    """The keys compared as float32, which cannot tell apart keys closer
    than its step."""
    return take(a["keys"], float_order(a["keys"]))


def compare(got, want) -> dict:
    return {"key_mismatches": rows_differ([got], [want], want.shape[0])}
