"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` — one ``nvcc``
per source, all started together — and the objects are linked into one
shared library with a plain C interface, ``_build/libindigo_kernels.so``
inside the package, loaded with ``ctypes``. The build runs on first use,
from the package's own sources only, and again whenever their content hash
changes (the hash is stored beside the library). Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "build_dir", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_LIB_NAME = "libindigo_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def build_dir():
    return os.path.join(_PKG, "_build")


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _source_hash(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(srcs, out, stamp, digest):
    os.makedirs(build_dir(), exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(build_dir(), f"{os.path.basename(s)}.{tag}.o")
            for s in cus]
    cmds = [[nvcc] + NVCC_FLAGS + ["-c", s, "-o", o]
            for s, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    runs = [(c, p.returncode, o, e)
            for c, p, (o, e) in zip(cmds, procs, outs)]
    tmp = f"{out}.{tag}"
    if all(rc == 0 for _, rc, _, _ in runs):
        link = [nvcc] + NVCC_FLAGS[:2] + ["-shared", "-o", tmp] + objs
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.returncode, proc.stdout, proc.stderr))
    with open(os.path.join(build_dir(), "build.log"), "w") as f:
        for c, rc, o, e in runs:
            f.write(" ".join(c) + f"\n(rc {rc})\n" + o + e)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, rc, e) for c, rc, _, e in runs if rc != 0]
    if failed:
        c, rc, e = failed[0]
        raise RuntimeError(f"nvcc failed (rc {rc}): {' '.join(c)}\n"
                           f"{e[-4000:]}")
    os.replace(tmp, out)
    with open(stamp, "w") as f:
        f.write(digest)


def load_library():
    """The kernels' shared library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = _source_hash(srcs)
        out = os.path.join(build_dir(), _LIB_NAME)
        stamp = out + ".sha256"
        fresh = False
        if os.path.exists(out) and os.path.exists(stamp):
            with open(stamp) as f:
                fresh = f.read() == digest
        if not fresh:
            _build(srcs, out, stamp, digest)
        _lib = _declare(ctypes.CDLL(out))
        return _lib


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.indigo_toeplitz_fz.argtypes = [P, P, P, I, P, I, I, I, I, I, P]
    lib.indigo_toeplitz_plane.argtypes = [P, P, P, I, P, I, P, P, I, I, I, I,
                                          P]
    lib.indigo_toeplitz_ring_planes.argtypes = []
    lib.indigo_toeplitz_iz.argtypes = [P, P, P, I, P, I, I, I, I, I, P]
    lib.indigo_jag_spmm.argtypes = [P, P, P, P, I, I, P, P, I, I, P]
    lib.indigo_ell_spmm.argtypes = [P, P, P, P, I, I, P, P, I, I, P]
    lib.indigo_pad_idft.argtypes = [P, P, P, I, I, I, I, ctypes.c_longlong,
                                    I, P]
    for fn in (lib.indigo_toeplitz_fz, lib.indigo_toeplitz_plane,
               lib.indigo_toeplitz_iz, lib.indigo_toeplitz_ring_planes,
               lib.indigo_jag_spmm,
               lib.indigo_ell_spmm, lib.indigo_pad_idft):
        fn.restype = I
    lib.indigo_error_string.argtypes = [I]
    lib.indigo_error_string.restype = ctypes.c_char_p
    return lib
