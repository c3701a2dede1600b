"""Native (C++/OpenMP) host construction of the gridding matrix, via ctypes.

Counterpart of ``indigo_tpu/native``: ``gridding.cpp`` is a copy of the
reference's source (``tests/test_torch_native.py`` holds the two files
equal), built with the same ``g++`` command, so ``noncart.interp_mat``
gives the reference's matrix bit for bit wherever both libraries build.

The library is built on first use, never at import, into the package's
``_build/`` directory under a name that carries the hash of the source and
the compiler command, so a changed source builds a new library. Every
process that builds compiles into a temporary name of its own and renames
it into place, so a process never loads a library that another is still
writing. A failed build prints g++'s message; ``available()`` is then
false, ``interp_mat(impl="auto")`` takes the numpy build and
``impl="native"`` raises with that message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

__all__ = ["available", "kb_interp_ell", "build"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gridding.cpp")
_OUT = os.path.join(os.path.dirname(_DIR), "_build")
_CMD = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False
_error = None  # g++'s (or the loader's) message when the library is missing


def _lib_path():
    h = hashlib.sha256(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_OUT, f"libindigo_gridding.{h.hexdigest()[:16]}.so")


def build(force=False):
    """Compile the native library. Returns its path, or None on failure
    (g++'s message is printed, and ``interp_mat(impl="native")`` raises
    with it)."""
    global _error
    path = _lib_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(_CMD + [_SRC, "-o", tmp], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _error = f"g++ did not run: {e}"
    else:
        if proc.returncode == 0:
            os.replace(tmp, path)
            return path
        _error = f"g++ failed (rc {proc.returncode}): {proc.stderr.strip()}"
    if os.path.exists(tmp):
        os.remove(tmp)
    print(f"[indigo_tpu_torch.native] build failed: {_error}", file=sys.stderr)
    return None


def _open(path):
    """The library at ``path`` with its two functions declared."""
    lib = ctypes.CDLL(path)
    lib.kb_interp_ell.restype = ctypes.c_int64
    lib.kb_interp_ell.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
    ]
    lib.native_num_threads.restype = ctypes.c_int32
    lib.native_num_threads.argtypes = []
    return lib


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            _lib = _open(path)
        except OSError as e:
            _error = f"load failed: {e}"
            print(f"[indigo_tpu_torch.native] {_error}", file=sys.stderr)
        return _lib


def available():
    return _load() is not None


def num_threads():
    """OpenMP threads the C++ code runs on (0 when the library is missing)."""
    lib = _load()
    return 0 if lib is None else int(lib.native_num_threads())


def _interp_ell(lib, traj, grid_shape, width, beta):
    traj = np.ascontiguousarray(traj, dtype=np.float64)
    M, ndim = traj.shape
    grid = np.ascontiguousarray(grid_shape, dtype=np.int64)
    if grid.shape != (ndim,):
        raise ValueError(f"grid {tuple(grid)} for {ndim}-D samples")
    row_nnz = width ** ndim
    cols = np.empty((M, row_nnz), dtype=np.int64)
    wts = np.empty((M, row_nnz), dtype=np.float32)
    r = lib.kb_interp_ell(
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(M), ctypes.c_int32(ndim),
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(width), ctypes.c_double(float(beta)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if r != row_nnz:
        return None
    return cols, wts


def kb_interp_ell(traj, grid_shape, width, beta):
    """Element-ELL interpolation weights via the native C++ code.

    Returns (cols (M, width^d) int64, wts (M, width^d) float32), or None if
    the native library is unavailable or rejects the arguments (d > 4,
    width outside 2..16, width^d > 4096).
    """
    lib = _load()
    if lib is None:
        return None
    return _interp_ell(lib, traj, grid_shape, width, beta)
