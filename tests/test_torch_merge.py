"""The port's 8-way merge pass (lsdradixsort_tpu_torch/kernels/merge.py)
on CPU tensors — its plain PyTorch version — against the JAX package's
Pallas merge pass in interpret mode, on the same numpy input.

Shrunken geometry as tests/test_merge.py: runs of 2^10, blk=128,
buf=2^13 on the JAX side (the port needs neither). Outputs are integers
and must agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import merge as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import merge as T

L = 1 << 10
BLK = 128
MAXBUF = 1 << 13


def _runs(cols, nruns):
    """Sort each run of L rows of (key, val0, riders...) by (key, val0)."""
    out = [c.reshape(nruns, L).copy() for c in cols]
    for r in range(nruns):
        order = (np.lexsort((out[1][r], out[0][r])) if len(cols) > 1
                 else np.argsort(out[0][r], kind="stable"))
        for c in out:
            c[r] = c[r][order]
    return [c.reshape(-1) for c in out]


def _jax_pass(cols):
    buf = J.pass_buf_elems(L, MAXBUF)
    tab, ok = J.merge_pass_tables(jnp.asarray(cols[0]), L, buf, BLK)
    assert bool(ok)
    k, vs = J.merge_pass_multi(jnp.asarray(cols[0]),
                               [jnp.asarray(c) for c in cols[1:]], tab,
                               run_len=L, buf_elems=buf, blk=BLK)
    return [np.asarray(k)] + [np.asarray(v) for v in vs]


def _port_pass(cols):
    k, vs = T.merge_pass_multi(from_numpy(cols[0]),
                               [from_numpy(c) for c in cols[1:]], L)
    return [to_numpy(k)] + [to_numpy(v) for v in vs]


@pytest.mark.parametrize("npay,nruns", [(0, 8), (1, 8), (2, 8), (2, 4)])
def test_merge_pass_matches_jax(npay, nruns):
    # a full group of 8 runs, and a pass whose only group holds 4 runs
    rng = np.random.default_rng(20 + npay)
    n = nruns * L
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[: n // 4] %= 37                                  # heavy ties too
    cols = [k, np.arange(n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)]
    cols = _runs(cols[:1 + npay], nruns)
    want = _jax_pass(cols)
    got = _port_pass(cols)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.sort(cols[0]))


def test_merge_pass_payload_compared_unsigned():
    # val0 breaks key ties unsigned (merge.py:388-389), unlike
    # sort_tiles_kv's signed compare; riders follow their rows
    rng = np.random.default_rng(23)
    n = 8 * L
    k = rng.integers(0, 3, n, dtype=np.uint32)
    v0 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v1 = np.arange(n, dtype=np.uint32)
    cols = _runs([k, v0, v1], 8)
    want = _jax_pass(cols)
    got = _port_pass(cols)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    order = np.lexsort((cols[1], cols[0]))
    np.testing.assert_array_equal(got[1], cols[1][order])


@pytest.mark.parametrize("nruns", [16, 11, 2])
def test_merge_pass_groups_plain(nruns):
    # several groups, a ragged last group, and a 2-run pass: each group of
    # up to 8 runs becomes one stably merged run
    rng = np.random.default_rng(24)
    n = nruns * L
    cols = _runs([rng.integers(0, 50, n, dtype=np.uint32),
                  np.arange(n, dtype=np.uint32)], nruns)
    got = _port_pass(cols)
    for g in range(0, nruns, 8):
        s = slice(g * L, min(g + 8, nruns) * L)
        order = np.lexsort((cols[1][s], cols[0][s]))
        np.testing.assert_array_equal(got[0][s], cols[0][s][order])
        np.testing.assert_array_equal(got[1][s], cols[1][s][order])


def test_merge_pass_wrappers_and_counters():
    rng = np.random.default_rng(25)
    k = _runs([rng.integers(0, 9, 8 * L, dtype=np.uint32),
               np.arange(8 * L, dtype=np.uint32)], 8)
    launches, plain = dict(T.LAUNCHES), dict(T.PLAIN_CALLS)
    keys = to_numpy(T.merge_pass(from_numpy(k[0]), L))
    sk, sv = T.merge_pass_kv(from_numpy(k[0]), from_numpy(k[1]), L)
    np.testing.assert_array_equal(keys, np.sort(k[0]))
    np.testing.assert_array_equal(to_numpy(sk), keys)
    np.testing.assert_array_equal(to_numpy(sv),
                                  k[1][np.lexsort((k[1], k[0]))])
    assert T.LAUNCHES == launches
    assert T.PLAIN_CALLS["merge_pass_multi"] == plain["merge_pass_multi"] + 2


def test_merge_pass_invalid_inputs_raise():
    k = torch.zeros(3 * L, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        T.merge_pass(k, 2 * L)                         # n % run_len != 0
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k] * 8, L)              # too many streams
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k, k], L, ncmp=4)
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k], L, ncmp=3)          # 2 streams
    with pytest.raises(ValueError):
        T.merge_pass_multi(k, [k[:L]], L)              # length mismatch
