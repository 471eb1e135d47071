"""A resident file of fixed-width binary records as the Sort Benchmark's
gensort lays them out: `record_bytes` a record, the first `key_bytes` of
them the key, uniform random bytes (the Indy category's uniform keys),
then the payload. The keys are drawn on the device from the seed in one
call; the payload holds each record's index (4 bytes, little-endian, so a
moved row can be told) and a fixed filler of ASCII capitals."""
from __future__ import annotations

import torch

INDEX_BYTES = 4


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    n = int(config["records"])
    width = int(config["record_bytes"])
    key = int(config["key_bytes"])
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    records = torch.empty((n, width), dtype=torch.uint8, device=device)
    records[:, :key] = torch.randint(0, 256, (n, key), dtype=torch.uint8,
                                     device=device, generator=g)
    idx = min(INDEX_BYTES, width - key)
    records[:, key:key + idx] = (
        torch.arange(n, dtype=torch.int32, device=device)
        .view(torch.uint8).view(n, INDEX_BYTES)[:, :idx])
    filler = width - key - idx
    records[:, key + idx:] = (torch.arange(filler, device=device) % 26
                              + ord("A")).to(torch.uint8)
    return {"records": records}
