"""Order-preserving key codecs: int32/float32 (and descending order) on
the uint32 sort engine — the PyTorch counterpart of
lsdradixsort_tpu/core/keycodec.py, with the same bijections:

  * int32   -> flip the sign bit: two's-complement order becomes unsigned.
  * float32 -> IEEE-754 sign-magnitude flip (negative -> NOT, non-negative
    -> set the sign bit): the IEEE total order
    -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN.
  * descending -> bitwise NOT of the code (tie groups are unchanged, so a
    stable ascending sort of the codes is a stable descending sort).
  * byte-string keys (the leading bytes of fixed-width binary records,
    compared as unsigned bytes, memcmp order) -> big-endian u32 words,
    the last one zero-filled at its low end (`encode_bytes`).

Codes are ``torch.uint32`` tensors. PyTorch's CPU build has no ``~`` or
``>>`` on uint32, so the arithmetic runs on the bit-identical int32 view
(``x.view(torch.int32)``), where the sign bit is bit 31 and XOR with
``-1`` is NOT; the result is viewed back as uint32.
"""
from __future__ import annotations

import torch

SIGN = -(1 << 31)   # 0x80000000 as an int32 bit pattern
ALL = -1            # 0xFFFFFFFF as an int32 bit pattern

#: dtypes `encode`/`decode` accept
SUPPORTED_KEY_DTYPES = (torch.uint32, torch.int32, torch.float32)

#: logical 64-bit key dtypes `encode64`/`decode64` accept
SUPPORTED_KEY_DTYPES64 = ("uint64", "int64", "float64")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _neg_mask(b: torch.Tensor) -> torch.Tensor:
    """All-ones where bit 31 of the int32 bit pattern is set, else zero."""
    return b >> 31          # arithmetic shift: -1 or 0


def encode(keys: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Map keys to uint32 codes whose unsigned ascending order equals the
    requested order on the original dtype."""
    dt = keys.dtype
    if dt not in SUPPORTED_KEY_DTYPES:
        raise TypeError(f"sortable key dtypes are u32/i32/f32, got {dt}")
    b = _bits(keys)
    if dt == torch.int32:
        b = b ^ SIGN
    elif dt == torch.float32:
        # negative: NOT (xor all ones); non-negative: set the sign bit
        b = b ^ (_neg_mask(b) | SIGN)
    if descending:
        b = b ^ ALL
    return b.view(torch.uint32)


def decode(codes: torch.Tensor, dtype, descending: bool = False
           ) -> torch.Tensor:
    """Inverse of `encode` (codes -> original-dtype keys)."""
    if dtype not in SUPPORTED_KEY_DTYPES:
        raise TypeError(f"sortable key dtypes are u32/i32/f32, got {dtype}")
    b = _bits(codes)
    if descending:
        b = b ^ ALL
    if dtype == torch.int32:
        b = b ^ SIGN
    elif dtype == torch.float32:
        # encoded non-negatives have the sign bit set: clear it; encoded
        # negatives have it clear: NOT them back
        b = b ^ ((_neg_mask(b) ^ ALL) | SIGN)
    return b.view(dtype)


# --- 64-bit keys as (hi, lo) u32 planes -----------------------------------

def encode64(hi: torch.Tensor, lo: torch.Tensor, dtype: str = "uint64",
             descending: bool = False):
    """Map (hi, lo) u32 planes of a 64-bit key to u32 code planes whose
    lexicographic (hi, lo) unsigned order equals the requested order.

    int64: flip the sign bit of hi. float64: IEEE sign-magnitude flip of
    the full 64 bits — total order, same NaN/-0.0 semantics as `encode`.
    """
    h, l = _bits(hi), _bits(lo)
    if dtype == "uint64":
        pass
    elif dtype == "int64":
        h = h ^ SIGN
    elif dtype == "float64":
        neg = _neg_mask(h)
        h = h ^ (neg | SIGN)
        l = l ^ neg
    else:
        raise TypeError(
            f"64-bit key dtypes are {SUPPORTED_KEY_DTYPES64}, got {dtype}")
    if descending:
        h, l = h ^ ALL, l ^ ALL
    return h.view(torch.uint32), l.view(torch.uint32)


def decode64(chi: torch.Tensor, clo: torch.Tensor, dtype: str = "uint64",
             descending: bool = False):
    """Inverse of `encode64` (code planes -> original (hi, lo) planes)."""
    if dtype not in SUPPORTED_KEY_DTYPES64:
        raise TypeError(
            f"64-bit key dtypes are {SUPPORTED_KEY_DTYPES64}, got {dtype}")
    h, l = _bits(chi), _bits(clo)
    if descending:
        h, l = h ^ ALL, l ^ ALL
    if dtype == "int64":
        h = h ^ SIGN
    elif dtype == "float64":
        neg = _neg_mask(h) ^ ALL  # encoded negatives have hi's sign clear
        h = h ^ (neg | SIGN)
        l = l ^ neg
    return h.view(torch.uint32), l.view(torch.uint32)


# --- byte-string keys of fixed-width records -------------------------------

def encode_bytes(records: torch.Tensor, key_bytes: int) -> list:
    """The first `key_bytes` bytes of each row of an (n, R) uint8 tensor as
    ceil(key_bytes / 4) contiguous (n,) uint32 columns whose lexicographic
    unsigned order is the memcmp order of the key bytes: word w holds bytes
    4w..4w+3 big-endian, and the bytes of the last word past the key are
    zero."""
    if records.dtype != torch.uint8 or records.dim() != 2:
        raise TypeError(f"records are an (n, R) uint8 tensor, got "
                        f"{records.dtype} {tuple(records.shape)}")
    n, width = records.shape
    if not 1 <= key_bytes <= width:
        raise ValueError(f"key_bytes={key_bytes} must be in 1..R={width}")
    words = -(-key_bytes // 4)
    take = records[:, :min(4 * words, width)]
    if take.shape[1] < 4 * words:
        take = torch.cat([take, take.new_zeros(n, 4 * words - take.shape[1])],
                         dim=1)
    # reversing each word's bytes makes its int32 view (little-endian) the
    # big-endian word; one copy, then one transpose into columns
    be = take.reshape(n, words, 4).flip(-1).reshape(n, 4 * words)
    cols = be.view(torch.int32).t().contiguous()
    tail = key_bytes - 4 * (words - 1)
    if tail < 4:
        cols[-1] &= -(1 << (32 - 8 * tail))
    return list(cols.view(torch.uint32).unbind(0))
