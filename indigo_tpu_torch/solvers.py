"""Iterative solvers on the device, with no host sync inside the loop.

Counterpart of ``indigo_tpu/solvers.py`` (``cg``, ``apgd``/``fista``,
``max_eigen``, ``soft_thresh``). The reference runs each solve as one
compiled ``lax.scan`` / ``lax.while_loop``; here the loop is Python, every
step is enqueued on the operands' device, and every decision (the ``tol``
freeze) is a ``torch.where`` on the device, so nothing waits for the device
until the caller reads the result. A solve runs where its tensors live,
and on the card when it is handed none: a numpy operand, or the start
vector of ``max_eigen``, goes to ``device`` if that is given, else to the
operator's device, else (a matvec callable, an operator without arrays) to
the card, and raises where there is none. ``device="cpu"`` asks for the
host. Host data is narrowed to 32-bit (float64 -> float32, complex128 ->
complex64) as the reference's boundary narrows it (``utils.as_tensor``).

``cg`` and ``max_eigen`` accept an
:class:`~indigo_tpu_torch.operators.Operator` or a plain matvec callable
and treat their operands as one long vector for inner products.
"""
from __future__ import annotations

import torch

from . import tracing
from .operators import Operator
from .utils import as_dtype, as_tensor, default_device

__all__ = ["cg", "apgd", "fista", "max_eigen", "soft_thresh"]


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


def _place(A, device):
    """Where a solve that was handed no tensor runs."""
    if device is None and isinstance(A, Operator):
        device = A.device
    return default_device(device)


def _operand(x, A, device, dtype=None):
    """x as a tensor: a tensor moves only to an explicit ``device``, host
    data goes where :func:`_place` says, narrowed (``utils.as_tensor``)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return as_tensor(x, _place(A, device), dtype)


def _norm(a):
    return torch.linalg.vector_norm(a.reshape(-1))


def cg(A, b, x0=None, lamda=0.0, tol=1e-6, maxiter=100, history=False,
       precond=None, device=None):
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
    z = M^{-1} r. ``b``, ``x0``: tensors or numpy arrays; ``device``: see
    the module docstring.
    """
    mv = _as_matvec(A)
    b = _operand(b, A, device)
    x0 = (torch.zeros_like(b) if x0 is None
          else _operand(x0, A, b.device, b.dtype))

    def matvec(v):
        with tracing.span("indigo.normal_op"):
            Av = mv(v)
        if not (isinstance(lamda, (int, float)) and lamda == 0):
            Av = Av + lamda * v
        return Av

    applyM = _as_matvec(precond) if precond is not None else (lambda r: r)

    with tracing.span("indigo.solve"):
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
            with tracing.span("indigo.cg_iter"):
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


def soft_thresh(x, lamda, device=None):
    """Complex soft-thresholding: the prox of lamda * ||.||_1.

    ``x``: a tensor (the result stays on its device) or host data (narrowed
    and put on ``device``, by default the card: ``utils.as_tensor``)."""
    x = as_tensor(x, device)
    mag = x.abs()
    scale = torch.clamp(mag - lamda, min=0.0) / torch.clamp(mag, min=1e-30)
    return (scale * x).to(x.dtype)


def apgd(gradf, proxg, alpha, x0, maxiter=100, history=False, tol=0.0,
         objective=None, device=None):
    """Accelerated proximal gradient descent (FISTA).

    Minimizes f(x) + g(x) given ``gradf(x)`` and ``proxg(v, step)`` with
    step size ``alpha``. ``x0``: a tensor (the solve runs on its device) or
    a numpy array (moved to ``device``, by default the card).

    ``tol``: optional stopping criterion on the relative step
    ||x_k - x_{k-1}|| / max(||x_k||, eps); once met, the iterate is frozen
    for the remaining steps (``torch.where``, as ``cg``) and
    ``info['iters']`` (0-d int32 tensor) reports the iterations actually
    taken. With ``tol == 0`` no convergence work is enqueued and the
    momentum ``t`` is host arithmetic. ``objective``: optional callable
    f(x) -> 0-d tensor evaluated each iteration into ``info['objs']`` when
    ``history=True``.

    Returns ``(x, info)``; with ``history=True`` info carries per-iteration
    step norms ``deltas`` (zero after convergence) and, if ``objective`` is
    given, ``objs``.
    """
    x0 = _operand(x0, None, device)
    dev = x0.device
    track = tol > 0
    x = z = x0
    t = torch.ones((), dtype=torch.float32, device=dev) if track else 1.0
    k = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    deltas, objs = [], []
    for _ in range(maxiter):
        xn = proxg(z - alpha * gradf(z), alpha)
        tn = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        zn = xn + ((t - 1.0) / tn) * (xn - x)
        if track or history:
            delta = _norm(xn - x)
        if track:
            rel = delta / torch.clamp(_norm(xn), min=1e-30)
            xn = torch.where(done, x, xn)
            zn = torch.where(done, z, zn)
            tn = torch.where(done, t, tn)
            k = torch.where(done, k, k + 1)
            if history:
                delta = torch.where(done, torch.zeros_like(delta), delta)
            done = done | (rel <= tol)
        x, z, t = xn, zn, tn
        if history:
            deltas.append(delta)
            if objective is not None:
                objs.append(torch.as_tensor(objective(x), device=dev))
    info = {"iters": k if track else k + maxiter}
    if history:
        empty = torch.zeros((0,), device=dev)
        info["deltas"] = torch.stack(deltas) if deltas else empty
        if objective is not None:
            info["objs"] = torch.stack(objs) if objs else empty
    return x, info


fista = apgd


def max_eigen(A, n, iters=30, key=None, dtype=torch.complex64, device=None):
    """Largest eigenvalue of Hermitian PSD ``A`` by power iteration (a 0-d
    real tensor); used to pick the FISTA step size alpha = 1 / L.

    ``key``: a ``torch.Generator`` or an int seed (None: seed 0) for the
    start vector, which is drawn on the host and moved; the stream differs
    from the reference's, so the two agree on the eigenvalue, not on the
    vector. ``dtype``: a torch or numpy dtype, 64-bit narrowed to 32-bit
    (``utils.as_dtype``). ``device``: where the iteration runs; by default
    the operator's device (a callable or an operator without arrays: the
    card).
    """
    mv = _as_matvec(A)
    device = _place(A, device)
    dtype = as_dtype(dtype)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(0 if key is None else int(key))
    v = torch.randn(n, generator=gen, dtype=torch.float32).to(
        device=device, dtype=dtype)
    v = v / _norm(v)
    lam = None
    for _ in range(iters):
        w = mv(v)
        lam = _vdot(v, w)
        v = w / torch.clamp(_norm(w), min=1e-30)
    return lam
