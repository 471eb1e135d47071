"""Run shuffles — the port of lsdradixsort_tpu/kernels/shuffle.py.

  * `shuffle_row_runs(x, src_rows, dst_rows, run_rows, out_rows)`: for each
    run i, ``out[dst_rows[i] : dst_rows[i] + len_i] = x[src_rows[i] : ..]``
    in whole rows of a (rows, 128) uint32 x; the output is (out_rows, 128).
  * `shuffle_elem_runs(x, src, dst, run_len, out_elems)`: the same on a 1-D
    uint32 x, any offsets and lengths.

What the JAX package computes, reproduced exactly on the covered words:

  * `fixed_rows > 0`: every run copies exactly `fixed_rows` rows, whatever
    `run_rows[i]` says (the TPU's pipelined fixed-size path).
  * Otherwise a length is decomposed by binary weight and only its bits
    0..mb are copied, mb = min(16, min(in_rows, out_rows).bit_length() - 1)
    for rows and min(max_len_bits, max(out_elems, 2).bit_length() - 1) for
    words: a run of length ln copies its items [ln & ~keep, ln), keep =
    2^(mb+1) - 1, at that same offset within the run.
  * Output items that no run covers are unspecified: zeros here on the
    CPU (as in interpret mode), whatever ``torch.empty`` held on the card.

Limits of the port (ROADMAP Queue C): destination runs must be disjoint
(overlaps have no defined order) and should lie inside both buffers; no
item before the start or past the end of x or the output is ever read or
written (interpret mode clamps the slice start instead, and on a TPU such
a run is undefined). x may be of any 4-byte dtype: its bits move, and
the output is uint32, as the JAX kernels' is. A row-shuffle x that is not
16-byte aligned (a view at an odd offset) is copied first, since the
kernel loads 16 bytes at a time. Any offset is taken: the TPU's
1024-word alignment of element runs is not a limit on the card. The run
tables are int32 or int64 tensors; `runs_per_step` must be a multiple of 8
(the TPU's SMEM blocking, otherwise unused) and `interpret` is accepted
and ignored.

On a CUDA tensor each wrapper launches ``csrc/shuffle.cu`` (one CTA a run;
its header says what bounds it), with the tables on the device and no host
sync. On a CPU tensor it runs the plain PyTorch version, which
`chip_smoke.py` also runs on the card to check the kernel. `LAUNCHES` and
`PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.profiling import annotate, host_value
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
MAX_LEN_BITS = 16   # row run lengths below 2^16 are never cut

LAUNCHES = {"shuffle_row_runs": 0, "shuffle_elem_runs": 0}
PLAIN_CALLS = {"shuffle_row_runs": 0, "shuffle_elem_runs": 0}


def _row_keep(in_rows: int, out_rows: int) -> int:
    mb = min(MAX_LEN_BITS, min(in_rows, out_rows).bit_length() - 1)
    return (1 << (mb + 1)) - 1


def _elem_keep(out_elems: int, max_len_bits: int) -> int:
    mb = min(max_len_bits, max(out_elems, 2).bit_length() - 1)
    return (1 << (mb + 1)) - 1


def _tables(x: torch.Tensor, runs_per_step: int, *tables):
    """The run tables as contiguous int32 tensors on x's device."""
    if runs_per_step % 8:
        raise ValueError("runs_per_step must be a multiple of 8")
    if x.element_size() != 4:
        raise ValueError(f"the shuffles move 4-byte words, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    out = [torch.as_tensor(t, device=x.device).to(torch.int32).contiguous()
           for t in tables]
    if any(t.dim() != 1 or t.shape[0] != out[0].shape[0] for t in out):
        raise ValueError("src, dst and lengths must be 1-D of one length")
    return out


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"x must be (rows, {LANES}), got {tuple(x.shape)}")


def _shuffle_plain(x, src, dst, lens, fixed, keep, out_items):
    """out[d : d + n] = x[s : s + n] over the truncated, clipped runs, by
    one index_put of every copied item; x is (items, width) int32."""
    in_items = x.shape[0]
    s, d = src.to(torch.int64), dst.to(torch.int64)
    if fixed:
        n = torch.full_like(s, fixed)
    else:
        ln = lens.to(torch.int64).clamp(min=0)
        skip = ln & ~keep
        s, d, n = s + skip, d + skip, ln - skip
    lo = torch.maximum(torch.maximum(-s, -d), torch.zeros_like(s))
    hi = torch.minimum(torch.minimum(n, in_items - s), out_items - d)
    n = (hi - lo).clamp(min=0)
    s, d = s + lo, d + lo
    total = host_value(n.sum())
    run = torch.repeat_interleave(torch.arange(n.shape[0], device=x.device), n,
                                  output_size=total)
    within = (torch.arange(total, device=x.device)
              - (torch.cumsum(n, 0) - n)[run])
    out = torch.zeros((out_items, x.shape[1]), dtype=torch.int32,
                      device=x.device)
    out[d[run] + within] = x[s[run] + within]
    return out.view(torch.uint32)


def shuffle_row_runs_plain(x, src_rows, dst_rows, run_rows, out_rows: int,
                           runs_per_step: int = 256, fixed_rows: int = 0,
                           interpret: bool | None = None) -> torch.Tensor:
    src, dst, lens = _tables(x, runs_per_step, src_rows, dst_rows, run_rows)
    _check_rows(x)
    PLAIN_CALLS["shuffle_row_runs"] += 1
    return _shuffle_plain(x.view(torch.int32), src, dst, lens, fixed_rows,
                          _row_keep(x.shape[0], out_rows), out_rows)


def shuffle_elem_runs_plain(x, src, dst, run_len, out_elems: int,
                            runs_per_step: int = 256, max_len_bits: int = 16,
                            interpret: bool | None = None) -> torch.Tensor:
    src, dst, lens = _tables(x, runs_per_step, src, dst, run_len)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    PLAIN_CALLS["shuffle_elem_runs"] += 1
    return _shuffle_plain(x.view(torch.int32).view(-1, 1), src, dst, lens, 0,
                          _elem_keep(out_elems, max_len_bits),
                          out_elems).view(-1)


def _launch(name: str, x, args) -> None:
    """Call C entry point lsd_<name>: five pointers, then long longs, then
    the stream."""
    with annotate("lsd.kernel." + name), torch.cuda.device(x.device):
        fn = _build.function(f"lsd_{name}", [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] * (len(args) - 5) + [ctypes.c_void_p])
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(*args, ctypes.c_void_p(stream)), f"lsd_{name}")
    LAUNCHES[name] += 1


def shuffle_row_runs(x: torch.Tensor, src_rows, dst_rows, run_rows,
                     out_rows: int, runs_per_step: int = 256,
                     fixed_rows: int = 0,
                     interpret: bool | None = None) -> torch.Tensor:
    """Copy row runs of x (rows, 128) uint32 to new offsets in a new
    (out_rows, 128) uint32 tensor; see the module docstring."""
    if x.device.type == "cpu":
        return shuffle_row_runs_plain(x, src_rows, dst_rows, run_rows,
                                      out_rows, runs_per_step, fixed_rows)
    src, dst, lens = _tables(x, runs_per_step, src_rows, dst_rows, run_rows)
    _check_rows(x)
    x = x.contiguous().view(torch.uint32)
    if x.data_ptr() % 16:                      # the kernel's 16-byte loads
        x = x.clone()
    out = torch.empty((out_rows, LANES), dtype=torch.uint32, device=x.device)
    _launch("shuffle_row_runs", x,
            [x.data_ptr(), out.data_ptr(), src.data_ptr(), dst.data_ptr(),
             lens.data_ptr(), src.shape[0], fixed_rows,
             _row_keep(x.shape[0], out_rows), x.shape[0], out_rows])
    return out


def shuffle_elem_runs(x: torch.Tensor, src, dst, run_len, out_elems: int,
                      runs_per_step: int = 256, max_len_bits: int = 16,
                      interpret: bool | None = None) -> torch.Tensor:
    """Element-granular run shuffle of a 1-D uint32 x into a new
    (out_elems,) uint32 tensor; see the module docstring."""
    if x.device.type == "cpu":
        return shuffle_elem_runs_plain(x, src, dst, run_len, out_elems,
                                       runs_per_step, max_len_bits)
    src, dst, lens = _tables(x, runs_per_step, src, dst, run_len)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    x = x.contiguous().view(torch.uint32)
    out = torch.empty(out_elems, dtype=torch.uint32, device=x.device)
    _launch("shuffle_elem_runs", x,
            [x.data_ptr(), out.data_ptr(), src.data_ptr(), dst.data_ptr(),
             lens.data_ptr(), src.shape[0],
             _elem_keep(out_elems, max_len_bits), x.shape[0], out_elems])
    return out
