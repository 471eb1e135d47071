"""The reduction after the sort of a filtered GROUP BY SUM
(ops/aggregate.py `filtered_group_by_sum`), one pass on the card.

  * `filtered_run_sums(sk, spacked, sv)`: three (n,) uint32 streams
    sorted by (group key, packed), where packed is (rejected << 31) |
    position. A row is kept where packed < 2^31; a kept row ends a run
    where the next row's key or kept flag differs, or where it is the
    last row. Returns (count, keys, sums): the number of run ends as a
    0-dim uint32 tensor, and (n,) uint32 outputs whose first count rows
    are each run end's key and the sum of its run's kept values mod
    2^32. The rows from count on are unspecified (never filled).

The JAX package computes this with whole-column steps: a running sum of
the kept values, the run-end flags, a compaction of the run ends, and
the differences of their running sums. The plain version here is that
sequence in PyTorch (ops/aggregate.py `running_sum`, `differs_from_next`,
`run_differences`, ops/filter.py `compact`), which widens columns to
int64 and takes the differences over all n rows. On the card
(``csrc/aggregate.cu``, whose header gives the design) it is one launch:
each CTA reads a tile of the three streams once, and a decoupled
look-back (``csrc/single_pass.cuh``) carries each tile's count of run
ends and the sum since its last one, so every run end writes its key and
its run's sum directly. Any n below 2^31 and any alignment; the count
stays on the device, so no host sync.

On a CPU tensor the wrapper runs the plain version, which `chip_smoke.py`
also runs on the card to check the kernel. `LAUNCHES` (one a launch) and
`PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

CTA_THREADS = 256       # threads of a CTA of csrc/aggregate.cu (kThreads)
ROWS = 32               # rows a thread (kRows)
TILE_ROWS = CTA_THREADS * ROWS

LAUNCHES = {"filtered_run_sums": 0}
PLAIN_CALLS = {"filtered_run_sums": 0}

_SPAN = "lsd.kernel.filtered_run_sums"


def _check(sk: torch.Tensor, spacked: torch.Tensor, sv: torch.Tensor) -> None:
    n = sk.shape[0] if sk.dim() == 1 else -1
    for x in (sk, spacked, sv):
        if x.dtype != torch.uint32 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError("filtered_run_sums takes three (n,) torch.uint32 "
                             f"streams, got {x.dtype} {tuple(x.shape)}")
        if x.device != sk.device:
            raise ValueError("the streams must be on one device")
    if n >= 1 << 31:
        raise ValueError(f"n={n} must be below 2^31")
    if sk.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sk.device}")


def filtered_run_sums_plain(sk: torch.Tensor, spacked: torch.Tensor,
                            sv: torch.Tensor):
    """Plain PyTorch version: the JAX package's whole-column sequence."""
    # ops/aggregate.py imports this module: import its helpers at the call
    from lsdradixsort_tpu_torch.ops.aggregate import (differs_from_next,
                                                      run_differences,
                                                      running_sum)
    from lsdradixsort_tpu_torch.ops.filter import compact
    _check(sk, spacked, sv)
    PLAIN_CALLS["filtered_run_sums"] += 1
    kept = spacked.view(torch.int32) >= 0
    sums = running_sum(torch.where(kept, sv.view(torch.int32), 0)
                       .view(torch.uint32))
    is_last = (differs_from_next(sk) | differs_from_next(kept)) & kept
    count, uk, run_end_sums = compact(is_last, sk, sums)
    return count, uk, run_differences(run_end_sums)


@functools.cache
def _entry():
    return _build.function("lsd_filtered_runs", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])


def _launch(sk: torch.Tensor, spacked: torch.Tensor, sv: torch.Tensor):
    n = sk.shape[0]
    count = torch.empty(1, dtype=torch.int32, device=sk.device)
    uk, sums = torch.empty_like(sk), torch.empty_like(sk)
    if n == 0:
        return count.zero_().view(torch.uint32).reshape(()), uk, sums
    sk, spacked, sv = (x.contiguous() for x in (sk, spacked, sv))
    dev = sk.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    status = _build.lookback_status(dev, stream, -(-n // TILE_ROWS) + 2)
    _build.check(_entry()(
        sk.data_ptr(), spacked.data_ptr(), sv.data_ptr(), n, uk.data_ptr(),
        sums.data_ptr(), count.data_ptr(), status.data_ptr(), dev, stream),
        "lsd_filtered_runs")
    LAUNCHES["filtered_run_sums"] += 1
    return count.view(torch.uint32).reshape(()), uk, sums


def filtered_run_sums(sk: torch.Tensor, spacked: torch.Tensor,
                      sv: torch.Tensor):
    """(count, keys, sums) of the runs of kept rows in sorted streams; see
    the module docstring."""
    if sk.device.type == "cpu":
        return filtered_run_sums_plain(sk, spacked, sv)
    _check(sk, spacked, sv)
    with annotate(_SPAN):
        return _launch(sk, spacked, sv)
