"""Entry point of the port: the flagship stable key-value sort step with
example arguments — the counterpart of ``__graft_entry__.entry()``."""
from __future__ import annotations

from lsdradixsort_tpu_torch.core.datagen import random_kv
from lsdradixsort_tpu_torch.ops.sort import sort_kv


def entry(device="cuda"):
    """Return (step, args): `step(keys, values)` is `sort_kv`, and args are
    2^20 uniform uint32 keys with their row ids as values, on `device`."""
    keys, values = random_kv(1 << 20, seed=0, device=device)

    def step(k, v):
        return sort_kv(k, v)

    return step, (keys, values)
