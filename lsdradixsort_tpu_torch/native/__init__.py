"""ctypes bindings for the native host runtime (liblsdnative.so).

The port's own copy of lsdradixsort_tpu/native/__init__.py (numpy and
ctypes only). The reference keeps its host layer in C++ (Utils.{h,cpp},
the CPU golden models inside LSDRadixSort.cu); this package is the
framework's equivalent: fast CPU oracles + deterministic data generation +
verification, compiled from the repo-root native/lsd_native.cpp (the
library both packages load) and loaded via ctypes (no pybind11). The
bench runner's sort suite times `radix_sort` as its host bar.

Every entry point has a numpy fallback so the framework works (slower)
without the compiled library; `available()` reports which path is active.
The build is a plain `make -C native`, invoked automatically on first use
if the .so is missing and a toolchain is present.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SO_PATH = _REPO_ROOT / "native" / "liblsdnative.so"
_lib = None
_tried = False


def _try_build() -> None:
    src = _REPO_ROOT / "native" / "lsd_native.cpp"
    if not src.exists():
        return
    try:
        subprocess.run(["make", "-C", str(_REPO_ROOT / "native")],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        pass


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO_PATH.exists():
        _try_build()
    if not _SO_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.lsd_fill_random_u32.argtypes = [u32p, ctypes.c_int64,
                                        ctypes.c_uint64, ctypes.c_uint32,
                                        ctypes.c_uint32]
    lib.lsd_check_arrays_u32.argtypes = [u32p, u32p, ctypes.c_int64]
    lib.lsd_check_arrays_u32.restype = ctypes.c_int64
    lib.lsd_check_sorted_u32.argtypes = [u32p, ctypes.c_int64]
    lib.lsd_check_sorted_u32.restype = ctypes.c_int64
    lib.lsd_exclusive_prefix_sum_u32.argtypes = [u32p, u32p, ctypes.c_int64]
    lib.lsd_block_histograms_u32.argtypes = [u32p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_int,
                                             ctypes.c_int, u32p]
    lib.lsd_transpose_u32.argtypes = [u32p, u32p, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.lsd_radix_sort_u32.argtypes = [u32p, u32p, ctypes.c_int64]
    lib.lsd_radix_sort_kv_u32.argtypes = [u32p, u32p, u32p, u32p,
                                          ctypes.c_int64]
    lib.lsd_radix_sort_pass_u32.argtypes = [u32p, u32p, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the compiled native library is loaded."""
    return _load() is not None


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def fill_random_u32(n: int, seed: int, lo: int = 0,
                    hi: int = 0xFFFFFFFF) -> np.ndarray:
    """Deterministic uniform u32 array in [lo, hi] (Utils.h:24-33 analog)."""
    lib = _load()
    out = np.empty(n, dtype=np.uint32)
    if lib is None:
        rng = np.random.default_rng(seed)
        out[:] = rng.integers(lo, int(hi) + 1, size=n, dtype=np.uint64
                              ).astype(np.uint32)
        return out
    lib.lsd_fill_random_u32(_u32p(out), n, seed, lo, hi)
    return out


def check_arrays(a: np.ndarray, b: np.ndarray) -> int:
    """First mismatching index, or -1 (CheckArrays, Utils.cpp:62-68)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.shape != b.shape:
        return 0
    lib = _load()
    if lib is None:
        neq = a.ravel() != b.ravel()
        idx = int(np.argmax(neq))
        return idx if neq.any() else -1
    return int(lib.lsd_check_arrays_u32(_u32p(a), _u32p(b), a.size))


def check_sorted(a: np.ndarray) -> int:
    """First out-of-order index, or -1 if ascending."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    lib = _load()
    if lib is None:
        bad = a[:-1] > a[1:]
        return int(np.argmax(bad)) + 1 if bad.any() else -1
    return int(lib.lsd_check_sorted_u32(_u32p(a), a.size))


def exclusive_prefix_sum(a: np.ndarray) -> np.ndarray:
    """Exclusive scan, u32 wraparound (PrefixSum, cu:128-139)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    lib = _load()
    if lib is None:
        out = np.cumsum(a, dtype=np.uint32)
        return np.concatenate([[np.uint32(0)], out[:-1]])
    out = np.empty_like(a)
    lib.lsd_exclusive_prefix_sum_u32(_u32p(a), _u32p(out), a.size)
    return out


def block_histograms(keys: np.ndarray, block: int, r: int,
                     group: int) -> np.ndarray:
    """(num_blocks, 2**r) digit histograms (BuildHistogramsCPU, cu:643-658)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.size
    assert n % block == 0
    nb, bins = n // block, 1 << r
    lib = _load()
    if lib is None:
        digits = (keys >> (r * group)) & (bins - 1)
        out = np.zeros((nb, bins), dtype=np.uint32)
        for b in range(nb):
            out[b] = np.bincount(digits[b * block:(b + 1) * block],
                                 minlength=bins).astype(np.uint32)
        return out
    out = np.empty((nb, bins), dtype=np.uint32)
    lib.lsd_block_histograms_u32(_u32p(keys), n, block, r, group, _u32p(out))
    return out


def transpose(a: np.ndarray) -> np.ndarray:
    """Blocked u32 transpose (Transpose, cu:483-494)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    rows, cols = a.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(a.T)
    out = np.empty((cols, rows), dtype=np.uint32)
    lib.lsd_transpose_u32(_u32p(a), _u32p(out), rows, cols)
    return out


def radix_sort(keys: np.ndarray) -> np.ndarray:
    """Stable ascending LSD byte-radix sort (LSDRadixSort, cu:62-69)."""
    out = np.array(keys, dtype=np.uint32, copy=True)
    lib = _load()
    if lib is None:
        return np.sort(out, kind="stable")
    tmp = np.empty_like(out)
    lib.lsd_radix_sort_u32(_u32p(out), _u32p(tmp), out.size)
    return out


def radix_sort_kv(keys: np.ndarray, vals: np.ndarray):
    """Stable kv LSD sort; returns (sorted_keys, permuted_vals)."""
    k = np.array(keys, dtype=np.uint32, copy=True)
    v = np.array(vals, dtype=np.uint32, copy=True)
    lib = _load()
    if lib is None:
        perm = np.argsort(k, kind="stable")
        return k[perm], v[perm]
    tk, tv = np.empty_like(k), np.empty_like(v)
    lib.lsd_radix_sort_kv_u32(_u32p(k), _u32p(v), _u32p(tk), _u32p(tv), k.size)
    return k, v


def radix_sort_pass(keys: np.ndarray, r: int, group: int) -> np.ndarray:
    """One stable LSD pass by digit `group` (LSDRadixSortPass, cu:25-54)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    lib = _load()
    if lib is None:
        digits = (keys >> (r * group)) & ((1 << r) - 1)
        return keys[np.argsort(digits, kind="stable")]
    out = np.empty_like(keys)
    lib.lsd_radix_sort_pass_u32(_u32p(keys), _u32p(out), keys.size, r, group)
    return out
