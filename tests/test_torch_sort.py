"""The port's sort operators (lsdradixsort_tpu_torch/ops/sort.py) on CPU
tensors against the JAX package's operators, on the same numpy input.

JAX runs its Pallas kernels in interpret mode at the shrunken geometry of
tests/test_merge.py (tile 2^10, blk=128, buf=2^13); the port takes the
same tile_log2 and accepts, but needs no, blk/max_buf. Outputs must
agree bit for bit.
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.core.keycodec import encode

# the ops packages export a function named `sort`: fetch the modules
J = importlib.import_module("lsdradixsort_tpu.ops.sort")
T = importlib.import_module("lsdradixsort_tpu_torch.ops.sort")

TILE_LOG = 10
GEOM = dict(tile_log2=TILE_LOG, max_buf=1 << 13, blk=128)


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "presorted",
                                  "reversed", "extremes", "small"])
def test_merge_sort_keys_adversarial(kind):
    rng = np.random.default_rng(31)
    n = 11 * (1 << 10) + 5
    x = {"uniform": rng.integers(0, 2**32, n, dtype=np.uint64)
         .astype(np.uint32),
         "all_equal": np.full(n, 0xDEADBEEF, np.uint32),
         "presorted": np.arange(n, dtype=np.uint32),
         "reversed": np.arange(n, dtype=np.uint32)[::-1].copy(),
         "extremes": rng.choice(np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF],
                                         np.uint32), n).astype(np.uint32),
         "small": rng.integers(0, 2**32, 1000, dtype=np.uint64)
         .astype(np.uint32)}[kind]
    got = to_numpy(T.merge_sort_keys(from_numpy(x), **GEOM))
    np.testing.assert_array_equal(got, np.sort(x))


def test_merge_sort_keys_ok_flag():
    x = from_numpy(np.arange(5000, dtype=np.uint32)[::-1].copy())
    out, ok = T.merge_sort_keys(x, skew_fallback=False, **GEOM)
    assert ok is True
    np.testing.assert_array_equal(to_numpy(out),
                                  np.arange(5000, dtype=np.uint32))


@pytest.mark.parametrize("n", [1 << 13, (1 << 14) - 777])
def test_merge_sort_ops_match_jax(n):
    # one JAX merge_sort_multi run (key, positions, rider) is the reference
    # for all three port ops: its keys are merge_sort_keys' output and its
    # positions merge_sort_with_ranks' (the JAX suite holds those equal)
    rng = np.random.default_rng(33)
    k = rng.integers(0, 50, n, dtype=np.uint32)        # heavy duplicates
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    wk, wv = J.merge_sort_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)], **GEOM)
    wk, (w0, w1) = np.asarray(wk), [np.asarray(w) for w in wv]
    gk, gv = T.merge_sort_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)], **GEOM)
    for g, w in zip([gk, *gv], [wk, w0, w1], strict=True):
        np.testing.assert_array_equal(to_numpy(g), w)
    rk, rr = T.merge_sort_with_ranks(from_numpy(k), **GEOM)
    np.testing.assert_array_equal(to_numpy(rk), wk)
    np.testing.assert_array_equal(to_numpy(rr), w0)
    np.testing.assert_array_equal(
        to_numpy(T.merge_sort_keys(from_numpy(k), **GEOM)), wk)
    np.testing.assert_array_equal(w0, np.argsort(k, kind="stable"))


def test_merge_sort_multi_sentinel_collision():
    # ragged n, 2 payloads, real rows equal to the (0xFFFFFFFF, 0xFFFFFFFF)
    # padding pair: the exact path keeps their riding payloads
    # (tests/test_merge.py:100-124)
    rng = np.random.default_rng(34)
    n = (1 << 13) - 100
    k = rng.integers(0, 50, n, dtype=np.uint32)
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hot = rng.choice(n, 5, replace=False)
    k[hot] = 0xFFFFFFFF
    v0[hot] = 0xFFFFFFFF
    wk, wv = J.merge_sort_multi(jnp.asarray(k), [jnp.asarray(v0),
                                                 jnp.asarray(v1)], **GEOM)
    gk, gv = T.merge_sort_multi(from_numpy(k), [from_numpy(v0),
                                                from_numpy(v1)], **GEOM)
    for g, w in zip([gk, *gv], [wk, *wv], strict=True):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(to_numpy(gv[1])[-5:], v1[np.sort(hot)])


@pytest.mark.parametrize("desc", [False, True])
def test_sort_kv_i32_keys_f32_payload_matches_jax(desc):
    rng = np.random.default_rng(35)
    n = 1 << 12
    k = rng.integers(-50, 50, n).astype(np.int32)      # many duplicates
    pay = rng.standard_normal(n).astype(np.float32)
    pay[:3] = [np.nan, -0.0, np.inf]                   # bits must survive
    # JAX's "xla" strategy: the same stable semantics as its merge engine
    wk, wv = J.sort_kv(jnp.asarray(k), jnp.asarray(pay), strategy="xla",
                       descending=desc)
    gk, gv = T.sort_kv(from_numpy(k), from_numpy(pay), tile_log2=9,
                       descending=desc)
    assert gk.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_numpy(gv).view(np.uint32),
                                  np.asarray(wv).view(np.uint32))
    perm = np.argsort(-k.astype(np.int64) if desc else k, kind="stable")
    np.testing.assert_array_equal(to_numpy(gv).view(np.uint32),
                                  pay[perm].view(np.uint32))


def test_sort_kv_payload_structures_and_xla():
    rng = np.random.default_rng(36)
    n = 3000
    k = rng.standard_normal(n).astype(np.float32)
    a = np.arange(n, dtype=np.uint32)
    b = rng.integers(-9, 9, n).astype(np.int32)
    wide = torch.arange(n, dtype=torch.int64)           # not 32-bit: "xla"
    perm = np.argsort(to_numpy(encode(from_numpy(k))),
                      kind="stable")
    for strategy in ("merge", "xla"):
        sk, (sa, sb) = T.sort_kv(from_numpy(k), (from_numpy(a),
                                                 from_numpy(b)),
                                 strategy=strategy, tile_log2=10)
        np.testing.assert_array_equal(to_numpy(sk), k[perm])
        np.testing.assert_array_equal(to_numpy(sa), a[perm])
        np.testing.assert_array_equal(to_numpy(sb), b[perm])
    sk, sw = T.sort_kv(from_numpy(k), wide)
    np.testing.assert_array_equal(sw.numpy(), perm)
    sk, [sl] = T.sort_kv(from_numpy(k), [from_numpy(a)], tile_log2=10)
    np.testing.assert_array_equal(to_numpy(sl), a[perm])


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("desc", [False, True])
def test_sort_dtypes_match_jax(dtype, desc):
    rng = np.random.default_rng(37)
    n = 1 << 12
    if dtype == np.int32:
        k = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
            np.int32)
    else:
        k = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
             ).astype(np.float32)
        k[:4] = [0.0, -0.0, np.inf, -np.inf]
    want = np.asarray(J.sort(jnp.asarray(k), strategy="xla",
                             descending=desc))
    for strategy in ("merge", "xla"):
        got = to_numpy(T.sort(from_numpy(k), strategy=strategy,
                              descending=desc))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_sort_with_ranks_and_argsort_match_jax():
    rng = np.random.default_rng(38)
    k = rng.standard_normal(4096).astype(np.float32)
    k[:6] = [0.0, -0.0, 0.0, np.inf, -np.inf, 1.0]
    for desc in (False, True):
        wk, wr = J.sort_with_ranks(jnp.asarray(k), descending=desc)
        gk, gr = T.sort_with_ranks(from_numpy(k), descending=desc)
        np.testing.assert_array_equal(to_numpy(gk).view(np.uint32),
                                      np.asarray(wk).view(np.uint32))
        np.testing.assert_array_equal(to_numpy(gr), np.asarray(wr))
    np.testing.assert_array_equal(to_numpy(T.argsort(from_numpy(k))),
                                  np.asarray(J.argsort(jnp.asarray(k))))


def test_strategies_and_dtypes_raise():
    x = from_numpy(np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError, match="n % block_size"):
        T.sort(x, strategy="composed")                 # 64 % 2^13
    with pytest.raises(ValueError, match="n % block_size"):
        T.sort_kv(x, x, strategy="composed", block_size=128)
    with pytest.raises(ValueError, match="n % block_size"):
        J.sort(jnp.asarray(np.arange(64, dtype=np.uint32)),
               strategy="composed")
    with pytest.raises(ValueError):
        T.sort(x, strategy="radix")
    with pytest.raises(TypeError):
        T.sort(torch.arange(8, dtype=torch.int16))


COMPOSED_KINDS = {
    "uniform": lambda rng, n: rng.integers(0, 2**32, n, dtype=np.uint64)
    .astype(np.uint32),
    "all_equal": lambda rng, n: np.full(n, 0xDEADBEEF, np.uint32),
    "sorted": lambda rng, n: np.sort(rng.integers(0, 2**32, n,
                                                  dtype=np.uint64)
                                     .astype(np.uint32)),
    "reverse": lambda rng, n: np.sort(rng.integers(0, 2**32, n,
                                                   dtype=np.uint64)
                                      .astype(np.uint32))[::-1].copy(),
    "few_uniques": lambda rng, n: rng.integers(0, 4, n, dtype=np.uint32),
    "extremes": lambda rng, n: rng.choice(
        np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32), n),
}


@pytest.mark.parametrize("kind", COMPOSED_KINDS)
def test_composed_sort_matches_jax(kind):
    # the JAX suite's composed geometry (tests/test_ops.py:27-34)
    keys = COMPOSED_KINDS[kind](np.random.default_rng(39), 1 << 13)
    want = np.asarray(J.sort(jnp.asarray(keys), strategy="composed",
                             block_size=1 << 10))
    got = T.sort(from_numpy(keys), strategy="composed", block_size=1 << 10)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(want, np.sort(keys))


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_composed_sort_digit_widths_match_jax(r):
    keys = COMPOSED_KINDS["uniform"](np.random.default_rng(40), 1 << 12)
    want = np.asarray(J.sort(jnp.asarray(keys), strategy="composed", r=r,
                             block_size=1 << 9))
    got = T.sort(from_numpy(keys), strategy="composed", r=r,
                 block_size=1 << 9)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("payload", ["u32", "f32", "tuple"])
def test_composed_sort_kv_stable_matches_jax(payload):
    rng = np.random.default_rng(41)
    n = 1 << 12
    keys = rng.integers(0, 50, n, dtype=np.uint32)     # heavy duplicates
    pos = np.arange(n, dtype=np.uint32)
    f = rng.standard_normal(n).astype(np.float32)
    f[:3] = [np.nan, -0.0, np.inf]                     # bits must survive
    vals = {"u32": [pos], "f32": [f], "tuple": [pos, f]}[payload]
    jv = tuple(jnp.asarray(v) for v in vals)
    tv = tuple(from_numpy(v) for v in vals)
    wk, wv = J.sort_kv(jnp.asarray(keys), jv if payload == "tuple" else jv[0],
                       strategy="composed", block_size=1 << 9)
    gk, gv = T.sort_kv(from_numpy(keys), tv if payload == "tuple" else tv[0],
                       strategy="composed", block_size=1 << 9)
    wv, gv = (wv, gv) if payload == "tuple" else ((wv,), (gv,))
    assert isinstance(gv, tuple) and len(gv) == len(vals)
    np.testing.assert_array_equal(to_numpy(gk), np.asarray(wk))
    perm = np.argsort(keys, kind="stable")
    for g, w, v in zip(gv, wv, vals, strict=True):
        np.testing.assert_array_equal(to_numpy(g).view(np.uint32),
                                      np.asarray(w).view(np.uint32))
        np.testing.assert_array_equal(to_numpy(g).view(np.uint32),
                                      v[perm].view(np.uint32))


def test_entry_step_sorts_stably():
    from lsdradixsort_tpu_torch.entry import entry
    step, (k, v) = entry("cpu")
    assert k.shape == (1 << 20,) and k.dtype == torch.uint32
    sk, sv = step(k, v)
    keys = to_numpy(k)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(to_numpy(sk), keys[perm])
    np.testing.assert_array_equal(to_numpy(sv), perm.astype(np.uint32))


def test_port_imports_no_jax():
    # conftest imports jax in this process, so check in a fresh one
    code = ("import sys; import lsdradixsort_tpu_torch.ops.sort, "
            "lsdradixsort_tpu_torch.entry, "
            "lsdradixsort_tpu_torch.bench.flagship, "
            "lsdradixsort_tpu_torch.kernels.histogram, "
            "lsdradixsort_tpu_torch.kernels.scan, "
            "lsdradixsort_tpu_torch.kernels.transpose, "
            "lsdradixsort_tpu_torch.core.digits, "
            "lsdradixsort_tpu_torch.core.roofline, "
            "lsdradixsort_tpu_torch.kernels.compaction, "
            "lsdradixsort_tpu_torch.kernels.fill_forward, "
            "lsdradixsort_tpu_torch.kernels.hash_table, "
            "lsdradixsort_tpu_torch.ops, "
            "lsdradixsort_tpu_torch.bench.query, "
            "lsdradixsort_tpu_torch.parallel, "
            "lsdradixsort_tpu_torch.parallel.mesh, "
            "lsdradixsort_tpu_torch.parallel.dist_hist, "
            "lsdradixsort_tpu_torch.parallel.dist_sort, "
            "lsdradixsort_tpu_torch.parallel.dist_query, "
            "lsdradixsort_tpu_torch.parallel.launch, "
            "lsdradixsort_tpu_torch.bench.partition, "
            "lsdradixsort_tpu_torch.bench.runner, "
            "lsdradixsort_tpu_torch.bench.dist; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lsdradixsort_tpu.')) or "
            "m == 'lsdradixsort_tpu']; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=False, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
