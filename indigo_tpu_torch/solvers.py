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


def _rowdot(a, b):
    """Re<a_s, b_s> for each row s of (S, n) ``a``, ``b``: (S, 1). On CUDA
    one ``vdot`` a row, no product array in device memory; on the host the
    summed products, whose order keeps the solves within their bars of the
    reference (a BLAS dot moves the 40^2 SenseRecon image 2e-4 off it)."""
    if not a.is_cuda:
        return torch.sum((a.conj() * b).real, dim=-1, keepdim=True)
    d = [torch.vdot(u, v).real for u, v in zip(a, b)]
    return d[0].reshape(1, 1) if len(d) == 1 else torch.stack(d)[:, None]


def _shift(mv, lamda):
    """v -> mv(v) + lamda * v; ``mv`` itself where lamda is a literal 0."""
    if isinstance(lamda, (int, float)) and lamda == 0:
        return mv
    return lambda v: mv(v) + lamda * v


def _cg_steps(mv, x, r, iters, tol=None, bnorm=None, precond=None,
              dot=_rowdot):
    """``iters`` CG steps on an (S, n) state, a system per row; each opens
    ``indigo.cg_iter`` and none waits for the device.

    ``mv``: the shifted operator; ``x``, ``r``: the start and b - mv(x);
    ``dot``: per-row real inner products, (S, 1). ``tol`` None runs every
    step; a number halts row s once ||r_s|| <= tol * ``bnorm`` (S, 1, zeros
    as 1; None: ||r_s|| at the start). Above 0 its state freezes; at 0 it
    has r = 0, which the clamped denominators hold, so only its count
    stops. Returns (x, k (S,) int32, ||r_s|| (iters + 1, S) at the start
    and after each step).
    """
    applyM = precond if precond is not None else (lambda v: v)
    p = applyM(r)
    rz, rs = dot(r, p), dot(r, r)
    k = torch.full(r.shape[:1], 0 if tol is not None else iters,
                   dtype=torch.int32, device=r.device)
    if tol is not None:
        if bnorm is None:
            bnorm = torch.sqrt(rs)
            bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
        thr = tol * bnorm
        done = torch.sqrt(rs) <= thr
    hist = [rs]
    for _ in range(iters):
        with tracing.span("indigo.cg_iter"):
            Ap = mv(p)
            alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
            xn = x + alpha * p
            rn = r - alpha * Ap
            z = applyM(rn)
            rzn = dot(rn, z)
            pn = z + (rzn / torch.clamp(rz, min=1e-30)) * p
            rsn = dot(rn, rn)
            if tol is not None and tol > 0:
                x, r, p, rz, rs = (torch.where(done, a, n) for a, n in (
                    (x, xn), (r, rn), (p, pn), (rz, rzn), (rs, rsn)))
            else:
                x, r, p, rz, rs = xn, rn, pn, rzn, rsn
            if tol is not None:
                k = torch.where(done[:, 0], k, k + 1)
                done = done | (torch.sqrt(rsn) <= thr)
            hist.append(rs)
    return x, k, torch.sqrt(torch.stack(hist)[..., 0])


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

    Every run enqueues exactly ``maxiter`` steps of ``batched_cg``'s loop:
    once ||r|| <= tol*||b|| (at tol 0: r = 0) the state stops changing,
    where the reference's ``while_loop`` would stop, so x, iters and resid
    equal the reference's without a host sync per step. ``precond``: an
    Operator or callable z = M^{-1} r. ``b``, ``x0``: tensors or numpy
    arrays; ``device``: see the module docstring.
    """
    mv = _as_matvec(A)
    b = _operand(b, A, device)
    x0 = (torch.zeros_like(b) if x0 is None
          else _operand(x0, A, b.device, b.dtype))
    shape = b.shape

    def flat(f):  # a map on b's shape as one on (1, n)
        return lambda v: f(v.reshape(shape)).reshape(1, -1)

    def normal(v):
        with tracing.span("indigo.normal_op"):
            return mv(v)

    matvec = _shift(flat(normal), lamda)
    if precond is not None:
        precond = flat(_as_matvec(precond))

    with tracing.span("indigo.solve"):
        b = b.reshape(1, -1)
        bnorm = torch.sqrt(_rowdot(b, b))
        bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
        x0 = x0.reshape(1, -1)
        x, k, norms = _cg_steps(matvec, x0, b - matvec(x0), maxiter, tol=tol,
                                bnorm=bnorm, precond=precond)
        rel = norms[:, 0] / bnorm[0, 0]
        info = {"iters": k[0], "resid": rel[-1]}
        if history:
            info["resids"] = rel[1:]
    return x.reshape(shape), info


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
        lam = torch.vdot(v.reshape(-1), w.reshape(-1)).real
        v = w / torch.clamp(_norm(w), min=1e-30)
    return lam
