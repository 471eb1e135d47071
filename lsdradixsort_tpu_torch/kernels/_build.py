"""Build and load the port's CUDA kernels.

nvcc compiles every ``lsdradixsort_tpu_torch/csrc/*.cu`` for
``sm_90a`` (one nvcc process a source, all started together) and links
the objects into one shared library with a plain C interface, which is
loaded with ctypes (no PyTorch headers, so the build takes seconds). The
build runs at first use, goes into ``build/torch_kernels/`` at the root of
the checkout, and is cached under a hash of the sources and flags: a
changed source builds a new library, an unchanged one is loaded again.
Non-static symbols share one namespace across the sources: keep kernels
and helpers in an anonymous namespace, and give each C entry point an
``lsd_`` name of its own.

Every C entry point returns a ``cudaError_t``; `check` raises on a
non-zero one. Pointers and the stream are passed as ``c_void_p``. The
single-pass kernels (``csrc/single_pass.cuh``) share one look-back
scratch a stream, `lookback_status`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels build only where the toolkit is")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the library unless it is already built; return its path.
    The file name carries a hash of the sources, the headers they share
    and the flags. nvcc's output
    (registers, shared memory, spills per kernel) is kept beside it in a
    ``.log`` file."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lsd_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = tmp.with_suffix(f".{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(obj.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, proc))
    logs, failed, errors = [], [], []
    for cmd, obj, proc in jobs:
        rc = proc.wait()
        logs.append(" ".join(cmd) + "\n" + obj.with_suffix(".log").read_text())
        obj.with_suffix(".log").unlink()
        if rc != 0:
            failed.append(f"{Path(cmd[-1]).name}: nvcc exit {rc}")
            errors.append(logs[-1])
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: nvcc exit {proc.returncode}")
            errors.append(logs[-1])
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    text = "\n".join(logs)
    out.with_suffix(".log").write_text(text)
    if failed:
        # the failing commands' own output, not the others' register lines
        detail = "\n".join(errors)[-4000:]
        raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n{detail}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lsd_error_string.argtypes = [ctypes.c_int]
            lib.lsd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `name` with its argument types declared; it returns
    an int cudaError_t."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().lsd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def pointers(tensors) -> ctypes.Array:
    """A C array of device pointers (None for a null pointer)."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


# (device index, stream handle) -> the look-back scratch of the single-pass
# kernels (csrc/single_pass.cuh): int64 words, zeroed once and left zero by
# every launch (its last CTA clears them), so launches in one stream's
# order share it
_STATUS: dict = {}


def lookback_status(dev: int, stream: int, words: int) -> torch.Tensor:
    """The look-back scratch of at least `words` words for launches on
    `stream` of device `dev`."""
    buf = _STATUS.get((dev, stream))
    if buf is None or buf.shape[0] < words:
        buf = torch.zeros(max(words, 1 << 10), dtype=torch.int64,
                          device=torch.device("cuda", dev))
        _STATUS[(dev, stream)] = buf
    return buf
