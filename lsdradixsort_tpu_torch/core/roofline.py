"""Device-memory roofline of the card: the port's copy of
lsdradixsort_tpu/core/roofline.py.

The reference's implicit roofline is the RTX 3060 Ti's 448 GB/s peak
(BASELINE.md). As in the JAX package, fractions and bounds are taken
against a measured ceiling, with the published spec kept for context:
for the H100 the ceiling is the rate of a device-to-device copy,
`dst.copy_(src)` of 1 GiB, read and write bytes counted, the median of 5
CUDA-event timings (`measure_copy_gbps`). A kernel that mostly reads (a
histogram) can beat that rate, since its traffic does not turn from
reads to writes: `measure_read_gbps` times the read alone, with a kernel
of its own (csrc/roofline.cu), since the library's reductions read slower
than a copy. `chip_smoke.py` runs both in phase 1 of every run and uses
them for that run's bounds.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# Published device-memory rate per card, GB/s (NVIDIA data sheets, SXM).
_SPEC_GBPS = {
    "H100": 3350.0,
    "H200": 4800.0,
    "cpu": 50.0,            # nominal, for CPU test runs
}

# Measured copy ceiling per card, GB/s (read + write): `measure_copy_gbps`
# in chip_smoke.py phase 1 on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (torch 2.11.0+cu128), 90 % of the 3350 GB/s spec.
_MEASURED_GBPS = {
    "H100": 2999.1,
}


@dataclass
class Roofline:
    device_kind: str
    hbm_gbps: float            # measured ceiling used for fractions
    spec_gbps: float = 0.0     # published spec, for context

    def fraction(self, bytes_moved: int, seconds: float) -> float:
        """Fraction of the ceiling achieved by moving bytes_moved in
        seconds."""
        return (bytes_moved / seconds) / (self.hbm_gbps * 1e9)

    def light_speed_s(self, bytes_moved: int) -> float:
        """Least seconds to move bytes_moved at the ceiling."""
        return bytes_moved / (self.hbm_gbps * 1e9)


def _lookup(table: dict, kind: str):
    return next((v for k, v in table.items() if k in kind), None)


def detect(device=None) -> Roofline:
    """The roofline of `device` (default: the current CUDA device, else
    the CPU). The kind is `torch.cuda.get_device_name`."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    spec = _lookup(_SPEC_GBPS, kind) or _SPEC_GBPS["H100"]
    measured = _lookup(_MEASURED_GBPS, kind) or spec
    return Roofline(device_kind=kind, hbm_gbps=measured, spec_gbps=spec)


def measure_copy_gbps(device="cuda", nbytes: int = 1 << 30,
                      iters: int = 5) -> float:
    """The card's copy rate, GB/s: read plus write bytes of
    `dst.copy_(src)` of `nbytes`, over the median of `iters` CUDA-event
    timings after a warm-up."""
    from lsdradixsort_tpu_torch.core.timing import time_fn
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
    src.fill_(1)
    dst = torch.empty_like(src)
    t = time_fn(dst.copy_, src, iters=iters)
    return 2 * nbytes / t.seconds / 1e9


def read_probe(x: torch.Tensor, out: torch.Tensor) -> None:
    """out[0] += the sum mod 2^32 of the 32-bit words of x (a CUDA tensor,
    16-byte aligned, a multiple of 4 words), each read once by
    csrc/roofline.cu `read_probe`; out is one int32 on the same card."""
    import ctypes

    from lsdradixsort_tpu_torch.kernels import _build
    with torch.cuda.device(x.device):
        fn = _build.function("lsd_read_probe", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p])
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(x.data_ptr(), x.numel(), out.data_ptr(),
                        ctypes.c_void_p(stream)), "lsd_read_probe")


def measure_read_gbps(device="cuda", nbytes: int = 1 << 29,
                      iters: int = 5) -> tuple[float, dict[str, float]]:
    """The card's read rate, GB/s: `nbytes` of random int32 words read
    once, with one word written, over the median of `iters` CUDA-event
    timings after a warm-up; by `read_probe` (checked against torch.sum
    first) and, for comparison, by `torch.amax`. Returns the faster rate
    and both."""
    from lsdradixsort_tpu_torch.core.timing import time_fn
    x = torch.randint(-(1 << 31), 1 << 31, (nbytes // 4,), dtype=torch.int32,
                      device=device)
    out = torch.zeros(1, dtype=torch.int32, device=device)
    read_probe(x, out)
    want = int(x.sum(dtype=torch.int64)) & 0xFFFFFFFF
    if int(out) & 0xFFFFFFFF != want:
        raise RuntimeError(f"read_probe: sum {int(out) & 0xFFFFFFFF:#x}, "
                           f"torch.sum {want:#x}")
    rates = {
        "read_probe": nbytes / time_fn(read_probe, x, out,
                                       iters=iters).seconds / 1e9,
        "amax": nbytes / time_fn(torch.amax, x, iters=iters).seconds / 1e9}
    return max(rates.values()), rates


def sort_pass_bytes(n: int, key_bytes: int = 4, value_bytes: int = 0) -> int:
    """Bytes one LSD radix pass must move at minimum: read keys(+values)
    for the histogram, read again for the scatter, write once."""
    row = key_bytes + value_bytes
    return n * (key_bytes + 2 * row)


def sort_bytes(n: int, r: int, key_bytes: int = 4,
               value_bytes: int = 0) -> int:
    """Light-speed total bytes for a full 32-bit LSD sort with r-bit
    digits."""
    passes = (32 + r - 1) // r
    return passes * sort_pass_bytes(n, key_bytes, value_bytes)
