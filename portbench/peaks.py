"""Published peaks of the cards the benchmark runs on, and the byte counts
that the roofline shares divide by them.

A share of a roofline is the least time the work could take at the
card's published memory rate, over the time it took: every input byte
read once and every output byte written once. These functions count the
bytes from the shapes alone, whatever the program does with them.
"""
from __future__ import annotations

# (substring of torch.cuda.get_device_name(), bytes/s): NVIDIA's data
# sheet of the H100 SXM ("NVIDIA H100 80GB HBM3"), whose 3.35 TB/s assumes
# its full 700 W power limit; the run prints the card's limit beside its
# numbers.
HBM_BYTES_PER_S = (
    ("H100 80GB HBM3", 3.35e12),
)

WORD = 4        # bytes of a u32 column's row


def hbm_bytes_per_s(kind: str) -> float | None:
    """The published memory rate of the card named `kind`, or None."""
    return next((rate for sub, rate in HBM_BYTES_PER_S if sub in kind), None)


def stream_pass_bytes(rows: int, streams: int) -> int:
    """One pass over `streams` u32 columns of `rows` rows, each read once
    and written once: a tile sort or a merge pass handed those rows."""
    return 2 * WORD * rows * streams


def columns_bytes(rows: int, columns: int) -> int:
    """`columns` u32 columns of `rows` rows, read or written once."""
    return WORD * rows * columns
