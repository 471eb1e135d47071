"""The port's run shuffles (lsdradixsort_tpu_torch/kernels/shuffle.py) on
CPU tensors — the plain PyTorch versions — against the JAX package's
Pallas kernels in interpret mode, on the same numpy input, with
runs_per_step=8 as tests/test_tile_sort.py runs them. Output items that no
run covers are unspecified (ROADMAP Queue C 2), so only the covered items
are compared, bit for bit; the rest must be zero on the CPU, as in
interpret mode, so that a run copied past its covered items shows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdradixsort_tpu.kernels import shuffle as J
from lsdradixsort_tpu_torch.core.convert import from_numpy, to_numpy
from lsdradixsort_tpu_torch.kernels import shuffle as S


def _covered(dst, lens, keep, out_items, fixed=0):
    """The output items the runs write: [dst + (ln & ~keep), dst + ln), or
    [dst, dst + fixed) on the fixed path, inside the output."""
    mask = np.zeros(out_items, bool)
    for d, ln in zip(dst.tolist(), lens.tolist()):
        lo, hi = (d, d + fixed) if fixed else (d + (ln & ~keep), d + ln)
        mask[max(lo, 0):max(min(hi, out_items), 0)] = True
    return mask


def _rows(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (rows, 128), dtype=np.uint64).astype(
        np.uint32)


def _check_rows(x, src, dst, lens, out_rows, fixed=0):
    want = np.asarray(J.shuffle_row_runs(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(lens),
        out_rows=out_rows, runs_per_step=8, fixed_rows=fixed))
    got = S.shuffle_row_runs(from_numpy(x), torch.from_numpy(src),
                             torch.from_numpy(dst), torch.from_numpy(lens),
                             out_rows, runs_per_step=8, fixed_rows=fixed)
    assert got.shape == (out_rows, 128) and got.dtype == torch.uint32
    cov = _covered(dst, lens, S._row_keep(x.shape[0], out_rows), out_rows,
                   fixed)
    assert cov.any()
    np.testing.assert_array_equal(to_numpy(got)[cov], want[cov])
    np.testing.assert_array_equal(to_numpy(got)[~cov], 0)
    return to_numpy(got), cov


@pytest.mark.parametrize("order", ["reversed", "permuted"])
@pytest.mark.parametrize("run,nch", [(8, 8), (4, 13)])
def test_row_runs_fixed(order, run, nch):
    # nch = 13: the run count is not a multiple of runs_per_step
    rows = 64
    x = _rows(rows, 1)
    src = np.arange(nch, dtype=np.int32) * run
    slot = (nch - 1 - np.arange(nch) if order == "reversed"
            else np.random.default_rng(2).permutation(nch))
    dst = (slot * run).astype(np.int32)
    lens = np.full(nch, run, np.int32)
    got, _ = _check_rows(x, src, dst, lens, rows, fixed=run)
    for i in range(nch):
        np.testing.assert_array_equal(got[dst[i]:dst[i] + run],
                                      x[src[i]:src[i] + run])


def test_row_runs_fixed_rows_overrides_run_rows():
    # every run copies fixed_rows = 8 rows, whatever run_rows says
    x = _rows(64, 3)
    src = np.array([0, 16, 40], np.int32)
    dst = np.array([24, 0, 48], np.int32)
    lens = np.array([3, 8, 1], np.int32)
    got, cov = _check_rows(x, src, dst, lens, 64, fixed=8)
    assert cov.sum() == 3 * 8
    np.testing.assert_array_equal(got[24:32], x[0:8])


@pytest.mark.parametrize("lens", [[5, 1, 26, 64], [7, 0, 3, 12, 1, 9, 30, 2,
                                                   5, 11, 16]])
def test_row_runs_variable(lens):
    rows = 160
    x = _rows(rows, 4)
    lens = np.array(lens, np.int32)
    src = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    order = np.random.default_rng(5).permutation(lens.size)
    dst = np.empty(lens.size, np.int32)
    acc = 3                    # an offset, so the runs start off row 0
    for r in order:
        dst[r] = acc
        acc += lens[r]
    got, _ = _check_rows(x, src, dst, lens, rows)
    for r in range(lens.size):
        np.testing.assert_array_equal(got[dst[r]:dst[r] + lens[r]],
                                      x[src[r]:src[r] + lens[r]])


def test_row_runs_length_truncation():
    # 16 output rows: mb = 4, so a run of 40 = 0b101000 rows copies only
    # its rows [32, 40) (bit 3), at offset 32 within the run
    x = _rows(64, 6)
    src = np.array([3, 50], np.int32)
    dst = np.array([-24, 0], np.int32)
    lens = np.array([40, 5], np.int32)
    got, cov = _check_rows(x, src, dst, lens, 16)
    assert S._row_keep(64, 16) == 31
    np.testing.assert_array_equal(got[8:16], x[35:43])
    assert cov.sum() == 8 + 5


def _check_elems(x, src, dst, lens, out_elems, max_len_bits=16):
    want = np.asarray(J.shuffle_elem_runs(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(lens),
        out_elems=out_elems, runs_per_step=8, max_len_bits=max_len_bits))
    got = S.shuffle_elem_runs(from_numpy(x), torch.from_numpy(src),
                              torch.from_numpy(dst), torch.from_numpy(lens),
                              out_elems, runs_per_step=8,
                              max_len_bits=max_len_bits)
    assert got.shape == (out_elems,) and got.dtype == torch.uint32
    cov = _covered(dst, lens, S._elem_keep(out_elems, max_len_bits),
                   out_elems)
    np.testing.assert_array_equal(to_numpy(got)[cov], want[cov])
    np.testing.assert_array_equal(to_numpy(got)[~cov], 0)
    return to_numpy(got), cov


def test_elem_runs_truncated_to_max_len_bits():
    # max_len_bits=2: a run of 13 = 0b1101 copies only its words 8..12
    x = np.arange(1000, 1064, dtype=np.uint32)
    src = np.array([5, 40], np.int32)
    dst = np.array([17, 2], np.int32)
    lens = np.array([13, 3], np.int32)
    got, cov = _check_elems(x, src, dst, lens, 64, max_len_bits=2)
    np.testing.assert_array_equal(np.flatnonzero(cov),
                                  [2, 3, 4, 25, 26, 27, 28, 29])
    np.testing.assert_array_equal(got[25:30], x[13:18])


def test_elem_runs_unaligned():
    # odd offsets and lengths, 11 runs (not a multiple of 8), permuted
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, 700, dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 40, 11).astype(np.int32)
    src = (np.cumsum(lens + rng.integers(1, 9, 11)) - lens).astype(np.int32)
    order = rng.permutation(11)
    dst = np.empty(11, np.int32)
    acc = 1
    for r in order:
        dst[r] = acc
        acc += lens[r] + 3
    got, cov = _check_elems(x, src, dst, lens, 640)
    assert cov.sum() == lens.sum()
    for r in range(11):
        np.testing.assert_array_equal(got[dst[r]:dst[r] + lens[r]],
                                      x[src[r]:src[r] + lens[r]])


def test_invalid_inputs_and_counters():
    x = torch.zeros((16, 128), dtype=torch.int32).view(torch.uint32)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        S.shuffle_row_runs(x, t, t, t, 16, runs_per_step=12)
    with pytest.raises(ValueError):
        J.shuffle_row_runs(jnp.zeros((16, 128), jnp.uint32), jnp.asarray(t),
                           jnp.asarray(t), jnp.asarray(t), out_rows=16,
                           runs_per_step=12)
    with pytest.raises(ValueError):
        S.shuffle_elem_runs(x.view(-1), t, t, t, 64, runs_per_step=4)
    with pytest.raises(ValueError):
        J.shuffle_elem_runs(jnp.zeros(64, jnp.uint32), jnp.asarray(t),
                            jnp.asarray(t), jnp.asarray(t), out_elems=64,
                            runs_per_step=4)
    # any 4-byte dtype moves as its uint32 bits; other widths are refused
    with pytest.raises(ValueError):
        S.shuffle_row_runs(x.view(torch.int16), t, t, t, 16)
    with pytest.raises(ValueError):
        S.shuffle_elem_runs(torch.zeros(64, dtype=torch.int64), t, t, t, 64)
    with pytest.raises(ValueError):
        S.shuffle_row_runs(x.view(32, 64), t, t, t, 16)
    rows = dict(S.PLAIN_CALLS)
    S.shuffle_row_runs(x, t, t, t + 1, 16)
    S.shuffle_elem_runs(x.view(-1), t, t, t + 1, 64)
    assert S.PLAIN_CALLS == {k: v + 1 for k, v in rows.items()}
    assert S.LAUNCHES == {"shuffle_row_runs": 0, "shuffle_elem_runs": 0}
