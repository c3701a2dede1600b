"""Utility helpers: random test data, relative error, timing, and the
port's boundary.

Counterpart of ``indigo_tpu/utils/__init__.py`` (``rand64c``, ``randM``,
``Timer``, ``rel_err``). ``rel_err`` works on numpy arrays and on torch
tensors (moved to the host first); the random helpers draw with numpy.

:func:`as_tensor` and :func:`default_device` are where user data becomes
tensors in every entry point of the port. They hold the reference's
boundary: host float64 / complex128 data is narrowed to float32 /
complex64, as ``jnp.asarray`` does in JAX's default 32-bit mode, and host
data goes to the card unless the caller names another device.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import tracing

__all__ = ["rand64c", "randM", "Timer", "rel_err"]

# what the reference's 32-bit boundary makes of 64-bit host data
NARROW = {np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


def as_dtype(dt):
    """A torch dtype from a torch or numpy dtype, by the same rule: a
    64-bit float or complex dtype becomes its 32-bit pair, as a ``dtype=``
    handed to the reference becomes 32-bit in JAX's default mode."""
    if not isinstance(dt, torch.dtype):
        dt = _torch_dtype(dt)
    return _NARROW_TORCH.get(dt, dt)


def _torch_dtype(dt):
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


_NARROW_TORCH = {_torch_dtype(k): _torch_dtype(v) for k, v in NARROW.items()}


def default_device(device=None):
    """``device`` as a ``torch.device``; None means the card. Raises when
    it means the card and there is none: the port never falls back to the
    host on its own, ``device="cpu"`` asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the host")
    return torch.device("cuda")


def common_device(*xs, device=None):
    """Where a call on ``xs`` runs: ``device`` if given, else the one
    device of the tensors among ``xs`` (a ValueError if they lie on two:
    nothing is moved on its own), else the card (:func:`default_device`)."""
    if device is not None:
        return torch.device(device)
    devs = {x.device for x in xs if torch.is_tensor(x)}
    if len(devs) > 1:
        raise ValueError(f"tensors on {sorted(map(str, devs))}: pass "
                         "device= to move them to one device")
    return devs.pop() if devs else default_device()


def as_tensor(x, device=None, dtype=None):
    """A tensor or host data (numpy, scipy sparse, lists, Python scalars)
    as a tensor, by the reference's boundary rule.

    A tensor keeps its dtype and device unless ``dtype`` / ``device`` are
    given. Host data is narrowed on the host (float64 -> float32,
    complex128 -> complex64, in an ``indigo.narrow`` span; integer and bool
    arrays keep their dtype, which torch indexing takes) unless ``dtype``
    is given, and goes to ``device``:
    by default the card, and an error where there is none
    (:func:`default_device`).
    """
    if torch.is_tensor(x):
        if device is None and dtype is None:
            return x
        return x.to(device=device, dtype=dtype)
    dev = default_device(device)
    a = x.toarray() if sp.issparse(x) else np.asarray(x)
    if dtype is None and a.dtype in NARROW:
        with tracing.span("indigo.narrow", bytes=a.nbytes):
            a = a.astype(NARROW[a.dtype])
    if not a.flags.writeable:
        a = a.copy()
    # cast on the host, so that only the narrow data crosses to the card
    return torch.as_tensor(a).to(dtype=dtype).to(dev)


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
