"""Reference-compatible backend facade.

Counterpart of ``indigo_tpu/backends.py``, which keeps the API shape of the
original indigo's ``get_backend(name)``: an object with operator factories
(``b.SpMatrix(...)``, ``b.UnscaledFFT(...)``), the device-primitive set
(``csrmm``, ``fftn``, ``axpby``, ``dot``, ...) and solvers (``b.cg``,
``b.apgd``), so scripts written against it port mechanically.

Here every name is the one torch backend on one device: a ``Backend`` is
(name, device), by default the card. Its factories build the port's
operators on that device, its solvers run there, and its primitives take
tensors or numpy arrays, move them there (host data narrowed to 32-bit by
``utils.as_tensor``, the port's one boundary rule), and return tensors
(``dot`` and ``norm2`` return Python numbers, ``copy_to`` numpy).
``csrmm`` applies an ``SpMatrix``, so a real matrix on the card runs
kernel K3 (jag) or K4 (blocked-ELL).
"""
from __future__ import annotations

import numpy as np
import torch

from . import operators as op, solvers
from .utils import as_tensor, rand64c, randM

__all__ = ["Backend", "get_backend", "available_backends"]


class Backend:
    """Facade bundling operator factories, primitives and solvers on one
    device (``device=None``: the card)."""

    def __init__(self, name="xla", device=None):
        self.name = name
        self.device = torch.device("cuda" if device is None else device)

    def _on(self, x):
        """x (tensor or array-like) as a tensor on the backend's device."""
        return as_tensor(x, self.device)

    def _apply(self, A, X, adjoint=False):
        X = self._on(X)
        if X.dim() == 1:
            return A.apply(X[:, None], adjoint=adjoint)[:, 0]
        return A.apply(X, adjoint=adjoint)

    # ---- operator factories (reference: b.SpMatrix(...) etc.) ----------
    def SpMatrix(self, A, **kw):
        return op.SpMatrix(A, device=self.device, **kw)

    def DenseMatrix(self, A, **kw):
        return op.DenseMatrix(A, device=self.device, **kw)

    def Diag(self, d, **kw):
        return op.Diag(d, device=self.device, **kw)

    def UnscaledFFT(self, shape, **kw):
        return op.UnscaledFFT(shape, device=self.device, **kw)

    def Eye(self, n, **kw):
        return op.Eye(n, device=self.device, **kw)

    def One(self, shape, **kw):
        return op.One(shape, device=self.device, **kw)

    def CropPad(self, in_shape, out_shape, **kw):
        return op.CropPad(in_shape, out_shape, device=self.device, **kw)

    def KronI(self, c, A, **kw):
        return op.KronI(c, A, **kw).to(self.device)

    def BlockDiag(self, blocks, **kw):
        return op.BlockDiag(blocks, **kw).to(self.device)

    def VStack(self, blocks, **kw):
        return op.VStack(blocks, **kw).to(self.device)

    def HStack(self, blocks, **kw):
        return op.HStack(blocks, **kw).to(self.device)

    def Scale(self, alpha, A, **kw):
        return op.Scale(alpha, A, **kw).to(self.device)

    # ---- solvers (reference: Backend.cg / Backend.apgd) ----------------
    def cg(self, A, b, x0=None, lamda=0.0, tol=1e-6, maxiter=100, **kw):
        kw.setdefault("device", self.device)
        return solvers.cg(A, b, x0=x0, lamda=lamda, tol=tol,
                          maxiter=maxiter, **kw)

    def apgd(self, gradf, proxg, alpha, x0, maxiter=100, **kw):
        kw.setdefault("device", self.device)
        return solvers.apgd(gradf, proxg, alpha, x0, maxiter=maxiter, **kw)

    # ---- primitive set (reference L1 contract) --------------------------
    def csrmm(self, A, X, adjoint=False):
        """Y = A @ X (or A^H @ X) for an SpMatrix operator or scipy CSR."""
        if not isinstance(A, op.SpMatrix):
            A = self.SpMatrix(A)
        return self._apply(A, X, adjoint)

    def fftn(self, X, vol_shape):
        return self._apply(op.UnscaledFFT(vol_shape), X)

    def ifftn(self, X, vol_shape):
        return self._apply(op.UnscaledFFT(vol_shape), X, adjoint=True)

    def cgemm(self, A, X, adjoint=False):
        from .ops.dft_fft import full_f32_matmul

        A, X = self._on(A), self._on(X)
        if A.is_cuda:
            full_f32_matmul()
        return (A.conj().T if adjoint else A) @ X

    def axpby(self, alpha, x, beta, y):
        """alpha*x + beta*y (functional; the reference mutated y)."""
        return alpha * self._on(x) + beta * self._on(y)

    def dot(self, x, y):
        return complex(torch.vdot(self._on(x).reshape(-1),
                                  self._on(y).reshape(-1)))

    def norm2(self, x):
        x = self._on(x).reshape(-1)
        return float(torch.vdot(x, x).real)

    def scale(self, alpha, x):
        return alpha * self._on(x)

    def onemm(self, M, X):
        """Reference's custom ones-matrix product (batched column sum)."""
        X = self._on(X)
        return op.One((M, X.shape[0])).apply(X)

    # ---- device array movement (reference: dndarray.copy_from/copy_to/
    # to_host) -------------------------------------------------------------
    def copy_from(self, host_array):
        """Host -> device: a tensor on the backend's device (complex data
        as complex64, where the reference returns split re/im planes)."""
        return self._on(host_array)

    def copy_to(self, device_array):
        """Device -> host numpy."""
        if torch.is_tensor(device_array):
            return device_array.detach().cpu().numpy()
        return np.asarray(device_array)

    to_host = copy_to

    # ---- misc ----------------------------------------------------------
    rand64c = staticmethod(rand64c)
    randM = staticmethod(randM)

    def __repr__(self):
        return f"<Backend {self.name} ({self.device})>"


_BACKENDS = {}


def get_backend(name="xla", device=None):
    """Name -> Backend on ``device`` (default the card). Every name of the
    reference ({xla, numpy, mkl, cuda, customcpu, customgpu}, or any other)
    is the torch backend; one Backend is kept per (name, device)."""
    key = (str(name).lower(), torch.device("cuda" if device is None
                                           else device))
    if key not in _BACKENDS:
        _BACKENDS[key] = Backend(*key)
    return _BACKENDS[key]


def available_backends():
    """The platforms torch sees: ``["cuda"]`` with a card, else
    ``["cpu"]``."""
    return ["cuda"] if torch.cuda.is_available() else ["cpu"]
