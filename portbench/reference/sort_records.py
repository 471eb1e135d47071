"""Fixed-width records sorted by their first key_bytes bytes compared as
unsigned bytes (memcmp order), stably: the key bytes as int64 columns of
at most 4 bytes each, big-endian (bytes 0-3, 4-7, 8-9 of a 10-byte key),
one stable torch.sort a column, least significant first, then the rows
taken in that order."""
from __future__ import annotations

import torch

CHUNK = 1 << 22     # rows compared at a time


def key_columns(records: torch.Tensor, key_bytes: int) -> list:
    """The key bytes of each row as int64 columns of up to 4 bytes."""
    cols = []
    for lo in range(0, key_bytes, 4):
        col = torch.zeros(records.shape[0], dtype=torch.int64,
                          device=records.device)
        for j in range(lo, min(lo + 4, key_bytes)):
            col = col * 256 + records[:, j].to(torch.int64)
        cols.append(col)
    return cols


def stable_order(cols: list) -> torch.Tensor:
    """Positions that sort rows by the columns, first column most
    significant, ties in input order."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for col in reversed(cols):
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def expect(a: dict) -> torch.Tensor:
    return a["records"][stable_order(key_columns(a["records"],
                                                 a["key_bytes"]))]


def control(a: dict) -> torch.Tensor:
    """The keys compared on their first 4 bytes only, ties in input
    order: rows whose keys share a 32-bit prefix keep their input order."""
    return a["records"][stable_order(key_columns(a["records"], 4))]


def compare(got, want) -> dict:
    """The count's gap, and the rows whose bytes differ from the
    reference's at the same place (a row the answer lacks differs)."""
    n = want.shape[0]
    if got.dim() != 2 or got.shape[1] != want.shape[1]:
        return {"count_diff": abs(got.shape[0] - n), "row_mismatches": n}
    m = min(n, got.shape[0])
    bad = 0
    for a in range(0, m, CHUNK):
        b = min(a + CHUNK, m)
        bad += int((got[a:b].to(want.device) != want[a:b]).any(dim=1).sum())
    return {"count_diff": abs(got.shape[0] - n),
            "row_mismatches": bad + (n - m)}
