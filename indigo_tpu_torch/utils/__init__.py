"""Utility helpers: random test data and relative error.

Counterpart of ``indigo_tpu/utils/__init__.py`` (``rand64c``, ``rel_err``).
Both work on numpy arrays and on torch tensors (moved to the host first).
"""
from __future__ import annotations

import numpy as np

__all__ = ["rand64c", "rel_err"]


def rand64c(*shape, rng=None):
    """Random complex64 numpy array with standard-normal real/imag parts.

    Same stream as ``indigo_tpu.utils.rand64c`` for the same ``rng``.
    """
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    r = rng.standard_normal(shape, dtype=np.float32)
    i = rng.standard_normal(shape, dtype=np.float32)
    return (r + 1j * i).astype(np.complex64)


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
