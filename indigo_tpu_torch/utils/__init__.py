"""Utility helpers: random test data, relative error, timing.

Counterpart of ``indigo_tpu/utils/__init__.py`` (``rand64c``, ``randM``,
``Timer``, ``rel_err``). ``rel_err`` works on numpy arrays and on torch
tensors (moved to the host first); the random helpers draw with numpy.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

__all__ = ["rand64c", "randM", "Timer", "rel_err"]


def rand64c(*shape, rng=None):
    """Random complex64 numpy array with standard-normal real/imag parts.

    Same stream as ``indigo_tpu.utils.rand64c`` for the same ``rng``.
    """
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    r = rng.standard_normal(shape, dtype=np.float32)
    i = rng.standard_normal(shape, dtype=np.float32)
    return (r + 1j * i).astype(np.complex64)


def randM(m, n, density=0.1, rng=None, dtype=np.complex64):
    """Random sparse CSR matrix of the given density.

    Same matrix as ``indigo_tpu.utils.randM`` for the same ``rng``.
    """
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    if np.issubdtype(dtype, np.complexfloating):
        vals = (rng.standard_normal(nnz)
                + 1j * rng.standard_normal(nnz)).astype(dtype)
    else:
        vals = rng.standard_normal(nnz).astype(dtype)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    return A


def _host(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(actual, desired):
    """Relative L2 error ||actual - desired|| / ||desired||."""
    actual = _host(actual)
    desired = _host(desired)
    denom = np.linalg.norm(desired.ravel())
    if denom == 0:
        return float(np.linalg.norm(actual.ravel()))
    return float(np.linalg.norm((actual - desired).ravel()) / denom)


class Timer:
    """Wall-clock timer context manager. It reads the host clock only: time
    work on the card after ``torch.cuda.synchronize()`` inside the block."""

    def __init__(self, name=""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def __repr__(self):
        return f"Timer({self.name!r}, elapsed={self.elapsed:.6f}s)"
