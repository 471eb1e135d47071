"""A resident table of uniform u32 keys, with a u32 payload column holding
each row's index where the traffic asks for one, made on the device from
the seed in one call per column."""
from __future__ import annotations

import torch


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    n = int(config["table_rows"])
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    keys = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         device=device, generator=g).view(torch.uint32)
    data = {"keys": keys}
    if traffic.get("payload") == "u32 row index":
        data["vals"] = torch.arange(n, dtype=torch.int32,
                                    device=device).view(torch.uint32)
    return data
