"""Iterative solvers on the device, with no host sync inside the loop.

Counterpart of ``indigo_tpu/solvers.py`` (``cg``). The reference runs the
solve as one compiled ``lax.scan`` / ``lax.while_loop``; here the loop is
Python, every step is enqueued on the operands' device, and every decision
(the ``tol`` freeze) is a ``torch.where`` on the device, so nothing waits
for the device until the caller reads the result.

``cg`` accepts an :class:`~indigo_tpu_torch.operators.Operator` or a plain
matvec callable and treats its operands as one long vector for inner
products.
"""
from __future__ import annotations

import numpy as np
import torch

from .operators import Operator

__all__ = ["cg"]


def _as_matvec(A):
    if isinstance(A, Operator):
        def mv(v):
            if v.dim() == 1:
                return A.apply(v[:, None])[:, 0]
            if v.dim() == 2:
                return A.apply(v)
            return A.apply(v.reshape(A.shape[1], -1)).reshape(v.shape)
        return mv
    return A


def _vdot(a, b):
    """Real inner product Re<a, b> over all elements (a 0-d tensor)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def _device_of(A):
    if isinstance(A, Operator):
        for t in A.buffers():
            return t.device
    return None


def cg(A, b, x0=None, lamda=0.0, tol=1e-6, maxiter=100, history=False,
       precond=None):
    """Conjugate Gradient for Hermitian positive-definite ``A`` (+ lamda*I).

    Solves (A + lamda*I) x = b. Returns ``(x, info)``: ``info["iters"]``
    (0-d int32 tensor) counts the steps taken and ``info["resid"]`` is the
    final relative residual ||r|| / ||b||; with ``history=True``,
    ``info["resids"]`` (maxiter,) holds the relative residual after each
    step (frozen after convergence), as in the reference.

    Every run enqueues exactly ``maxiter`` steps: once ||r|| <= tol*||b|| the
    state freezes (``torch.where``), which is where the reference's
    ``while_loop`` would stop, so x, iters and resid equal the reference's
    without a host sync per step. ``precond``: an Operator or callable
    z = M^{-1} r. ``b``, ``x0``: tensors (numpy arrays are moved to the
    operator's device).
    """
    mv = _as_matvec(A)
    if not torch.is_tensor(b):
        b = torch.as_tensor(np.asarray(b), device=_device_of(A))
    x0 = (torch.zeros_like(b) if x0 is None
          else torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0)
                               else x0, device=b.device).to(b.dtype))

    def matvec(v):
        Av = mv(v)
        if not (isinstance(lamda, (int, float)) and lamda == 0):
            Av = Av + lamda * v
        return Av

    applyM = _as_matvec(precond) if precond is not None else (lambda r: r)

    bnorm = torch.sqrt(_vdot(b, b))
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    x = x0
    r = b - matvec(x0)
    p = applyM(r)
    rz = _vdot(r, p)
    rs = _vdot(r, r)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = torch.sqrt(rs) <= tol * bnorm
    resids = []
    for _ in range(maxiter):
        Ap = matvec(p)
        alpha = rz / _vdot(p, Ap)
        xn = x + alpha * p
        rn = r - alpha * Ap
        z = applyM(rn)
        rzn = _vdot(rn, z)
        pn = z + (rzn / rz) * p
        rsn = _vdot(rn, rn)
        x = torch.where(done, x, xn)
        r = torch.where(done, r, rn)
        p = torch.where(done, p, pn)
        rz = torch.where(done, rz, rzn)
        rs = torch.where(done, rs, rsn)
        k = torch.where(done, k, k + 1)
        done = done | (torch.sqrt(rsn) <= tol * bnorm)
        if history:
            resids.append(torch.sqrt(rs) / bnorm)
    info = {"iters": k, "resid": torch.sqrt(rs) / bnorm}
    if history:
        info["resids"] = (torch.stack(resids) if resids
                          else torch.zeros((0,), device=b.device))
    return x, info
