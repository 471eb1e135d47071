"""Verification helpers.

Equivalent of CheckArrays (reference: Utils.cpp:62-68) — element-by-element
bit-exact comparison — and a *correct* CheckIfSorted (the reference's is
dead code with a digit/value confusion bug, Utils.cpp:70-80; SURVEY.md §2.3
says not to replicate it).
"""
from __future__ import annotations

import numpy as np


def check_arrays(actual, expected, label: str = "") -> None:
    """Assert bit-exact element-wise equality (CheckArrays equivalent)."""
    a = np.asarray(actual)
    e = np.asarray(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{label}: shape {a.shape} != {e.shape}")
    if a.dtype != e.dtype:
        raise AssertionError(f"{label}: dtype {a.dtype} != {e.dtype}")
    if not np.array_equal(a, e):
        bad = np.flatnonzero(a.ravel() != e.ravel())
        i = int(bad[0])
        raise AssertionError(
            f"{label}: {bad.size}/{a.size} mismatches; first at flat index "
            f"{i}: actual={a.ravel()[i]!r} expected={e.ravel()[i]!r}")


def check_sorted(a, label: str = "") -> None:
    """Assert ascending order (fixed CheckIfSorted, Utils.cpp:70-80)."""
    arr = np.asarray(a)
    if arr.size and np.any(arr[1:] < arr[:-1]):
        i = int(np.flatnonzero(arr[1:] < arr[:-1])[0])
        raise AssertionError(
            f"{label}: not sorted at index {i}: {arr[i]!r} > {arr[i+1]!r}")
