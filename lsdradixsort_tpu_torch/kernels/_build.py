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
non-zero one. Pointers and the stream are passed as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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


def build() -> Path:
    """Compile the library unless it is already built; return its path.
    The file name carries a hash of the sources and flags. nvcc's output
    (registers, shared memory, spills per kernel) is kept beside it in a
    ``.log`` file."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        rc = proc.wait()
        logs.append(" ".join(cmd) + "\n" + obj.with_suffix(".log").read_text())
        obj.with_suffix(".log").unlink()
        if rc != 0:
            failed.append(f"{Path(cmd[-1]).name}: nvcc exit {rc}")
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: nvcc exit {proc.returncode}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    text = "\n".join(logs)
    out.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n"
                           f"{text[-4000:]}")
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
