"""The port's sort of fixed-width binary records
(lsdradixsort_tpu_torch/ops/sort.py `sort_records`, core/keycodec.py
`encode_bytes`, kernels/records.py `gather_records`) on CPU tensors — the
kernels' plain versions — against the benchmark's plain reference
(portbench/reference/sort_records.py, torch only), byte for byte, and its
order against the JAX package's `sort_lex` of the same key words.

The JAX package has no records op: its `sort_lex` (strategy "xla", exact
and fast in interpret mode) orders the u32 words that `encode_bytes`
makes, and the port's answer must be the records taken in that order.
Keys are drawn from a 2- or 3-symbol alphabet, so every key word decides
some order and whole keys tie; each record's index in its payload shows
that ties keep their input order."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsdradixsort_tpu_torch as lsd
from lsdradixsort_tpu_torch.core import keycodec, profiling
from lsdradixsort_tpu_torch.core.convert import to_numpy
from lsdradixsort_tpu_torch.kernels import records as RC
from portbench.reference import sort_records as ref

J = importlib.import_module("lsdradixsort_tpu.ops.sort")

TILE_LOG = 10


def _records(n, width, key_bytes, symbols=3, seed=0):
    """n records of `width` bytes: keys over `symbols` byte values, then
    each record's index (4 bytes, where they fit) and random filler."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n, width), dtype=np.uint8)
    step = 255 // max(symbols - 1, 1)
    rec[:, :key_bytes] = (rng.integers(0, symbols, (n, key_bytes)) * step
                          ).astype(np.uint8)
    idx = np.arange(n, dtype=np.uint32).view(np.uint8).reshape(n, 4)
    fit = min(4, width - key_bytes)
    rec[:, key_bytes:key_bytes + fit] = idx[:, :fit]
    return torch.from_numpy(rec)


def _expect(rec, key_bytes):
    return ref.expect({"records": rec, "key_bytes": key_bytes})


@pytest.mark.parametrize("strategy", ["merge", "xla"])
@pytest.mark.parametrize("n,width,key_bytes,symbols", [
    (3000, 100, 10, 2), (2500, 100, 10, 3), (2000, 12, 1, 3),
    (2000, 16, 4, 3), (2000, 16, 5, 2), (2000, 101, 8, 2),
    (2000, 12, 12, 2), (1500, 101, 12, 2), (1, 100, 10, 3),
    (0, 100, 10, 3)])
def test_sort_records_matches_the_reference(n, width, key_bytes, symbols,
                                            strategy):
    rec = _records(n, width, key_bytes, symbols, seed=n + width + key_bytes)
    got = lsd.sort_records(rec, key_bytes, strategy=strategy,
                           tile_log2=TILE_LOG)
    assert got.dtype == torch.uint8 and got.shape == rec.shape
    assert torch.equal(got, _expect(rec, key_bytes))
    if n > 1:
        # whole keys tie: their records keep input order
        keys = [bytes(r) for r in got[:, :key_bytes].numpy()]
        assert len(set(keys)) < n


def test_sort_records_at_the_default_tile():
    rec = _records(5000, 100, 10, 3, seed=9)
    assert torch.equal(lsd.sort_records(rec), _expect(rec, 10))


@pytest.mark.parametrize("key_bytes", [1, 4, 5, 10, 12])
def test_the_order_is_the_jax_packages_sort_lex_of_the_key_words(key_bytes):
    rec = _records(2000, 100, key_bytes, 2, seed=key_bytes)
    words = keycodec.encode_bytes(rec, key_bytes)
    assert len(words) == -(-key_bytes // 4)
    _, perm = J.sort_lex([jnp.asarray(to_numpy(w)) for w in words],
                         strategy="xla")
    want = rec.numpy()[np.asarray(perm)]
    got = lsd.sort_records(rec, key_bytes, tile_log2=TILE_LOG)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key_bytes", [1, 3, 4, 6, 10, 12])
def test_encode_bytes_makes_big_endian_words(key_bytes):
    rec = _records(64, 14, key_bytes, 256, seed=key_bytes)
    words = keycodec.encode_bytes(rec[:, :max(key_bytes, 13)], key_bytes)
    a = rec.numpy()
    for w, col in enumerate(words):
        assert col.dtype == torch.uint32 and col.is_contiguous()
        b = np.zeros((64, 4), np.uint64)
        hi = min(4 * w + 4, key_bytes)
        b[:, :hi - 4 * w] = a[:, 4 * w:hi]
        want = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
        np.testing.assert_array_equal(to_numpy(col), want.astype(np.uint32))


def test_encode_bytes_and_sort_records_refuse_what_they_cannot_sort():
    rec = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        keycodec.encode_bytes(rec, 9)
    with pytest.raises(ValueError):
        keycodec.encode_bytes(rec, 0)
    with pytest.raises(TypeError):
        keycodec.encode_bytes(rec.view(torch.int32), 4)
    with pytest.raises(ValueError):
        lsd.sort_records(rec, 4, strategy="composed")


@pytest.mark.parametrize("n,m,width", [(500, 500, 100), (300, 700, 16),
                                       (257, 100, 101), (10, 0, 12)])
def test_gather_records_plain_is_numpy_fancy_indexing(n, m, width):
    rng = np.random.default_rng(n + m)
    rec = rng.integers(0, 256, (n, width), dtype=np.uint8)
    perm = rng.integers(0, n, m).astype(np.uint32)
    got = RC.gather_records(torch.from_numpy(rec),
                            torch.from_numpy(perm.view(np.int32))
                            .view(torch.uint32))
    np.testing.assert_array_equal(got.numpy(), rec[perm])


def test_gather_records_counts_its_calls_and_bytes():
    rec = torch.zeros((50, 100), dtype=torch.uint8)
    perm = torch.arange(30, dtype=torch.int32).view(torch.uint32)
    calls = RC.PLAIN_CALLS["gather_records"]
    before = profiling.counts()["record_bytes"]
    RC.gather_records(rec, perm)
    assert RC.PLAIN_CALLS["gather_records"] == calls + 1
    assert profiling.counts()["record_bytes"] == before + 30 * 100
    with pytest.raises(ValueError):
        RC.gather_records(rec.view(torch.int32), perm)
    with pytest.raises(ValueError):
        RC.gather_records(rec, perm.view(torch.int32))
