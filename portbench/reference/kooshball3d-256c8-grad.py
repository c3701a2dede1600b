"""Plain reference of the 3D kooshball SENSE block differentiated end to
end: the image and the gradient of the image loss in the k-space.

The forward is ``kooshball3d-256c8``'s reference, reused by import (the
radial DCF, the Toeplitz spectrum, the default lamda, the rhs
b = A^H W y, ``iters`` steps of ``common.cg`` on (normal + lamda I) x = b);
then L = 1/2 ||x - x_t||^2 against the configuration's target (its
phantom from ``target_seed``, ``configs/kooshball3d-256c8-grad.py``), and
dL/dy by torch autograd through ``common.cg`` and ``common.SenseNufft``'s
adjoint (its scatter and its DFT products).

One departure from plain autograd: the normal operator runs as an
autograd Function whose backward applies the same ``normal`` to the
cotangent. N = sum_c conj(s_c) T (s_c .) with a real spectrum is
Hermitian, so that is its vector-Jacobian product (the CPU tests hold
<u, N v> = <N u, v> and this gradient against autograd through ``normal``
unwrapped); it keeps the graph from holding each apply's doubled volumes.

The answer is one tensor, ``[x.ravel(), dL/dy.ravel()]``, as the program
hands its output over; ``numbers`` splits both at the k-space's length.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from portbench.lib import spec
from portbench.lib.harness import NOT_FINITE
from portbench.reference import common

koosh = spec.module("reference", "kooshball3d-256c8")
system = spec.module("configs", "kooshball3d-256c8-grad")


def apply_axis(x, R, axis, precision):
    """``common.apply_axis`` with the graph kept in every precision: for
    "tf32" the operand's rounding passes the gradient through unchanged."""
    x = torch.movedim(x, axis, -1)
    shape = x.shape
    xi = torch.view_as_real(x.contiguous()).reshape(-1, 2 * shape[-1])
    if precision == "tf32":
        r = common.tf32_round(xi.detach())
        xi = xi + (r - xi.detach()) if xi.requires_grad else r
    y = torch.view_as_complex((xi @ R).reshape(-1, R.shape[1] // 2, 2))
    return torch.movedim(y.reshape(shape[:-1] + (R.shape[1] // 2,)), -1,
                         axis)


def axes(precision, x, mats, first):
    """``SenseNufft._axes`` through :func:`apply_axis`."""
    for k, R in enumerate(mats):
        x = apply_axis(x, R, first + k, precision)
    return x


class Hermitian(torch.autograd.Function):
    """y = normal(x) for a Hermitian ``normal``; the backward is
    normal(g)."""

    @staticmethod
    def forward(ctx, normal, x):
        ctx.normal = normal
        return normal(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.normal(g)


class Reference(koosh.Reference):
    def __init__(self, cfg, traj, maps, precision, device):
        super().__init__(cfg, traj, maps, precision, device)
        self.A._axes = partial(axes, precision)
        self.xt = system.target(cfg, self.A.device).to(self.A.cdt)

    def hermitian_normal(self, x):
        return Hermitian.apply(self.normal, x)

    def answer(self, y, normal=None):
        """``[x.ravel(), dL/dy.ravel()]`` of k-space y (user order,
        coil-major); ``normal`` (default :meth:`hermitian_normal`) is the
        operator CG applies."""
        A = self.A
        with common.matmul_precision(self.precision), torch.enable_grad():
            yg = torch.as_tensor(np.asarray(y)).to(A.device, A.cdt)
            yg.requires_grad_()
            b = A.adjoint(self.w * yg.reshape(A.maps.shape[0], -1))
            x = common.cg(normal or self.hermitian_normal, b, self.lamda,
                          int(self.cfg["iters"]),
                          float(self.cfg.get("tol", 0.0)))
            d = torch.view_as_real(x - self.xt)
            (0.5 * torch.sum(d * d)).backward()
        return torch.cat([x.detach().reshape(-1), yg.grad.reshape(-1)])

    image = answer

    @staticmethod
    def numbers(y, answer, image):
        """The program's image and k-space gradient against the
        reference's: for each, the relative l2 gap and the largest gap
        over the largest reference value. An output of another length
        reads as not finite."""
        out = np.asarray(image).reshape(-1)
        m = int(np.asarray(y).size)
        if out.size != answer.numel():
            return dict.fromkeys(("img_rel_l2", "img_rel_max",
                                  "grad_rel_l2", "grad_rel_max"), NOT_FINITE)
        il2, imx = common.compare(out[:-m], answer[:-m])
        gl2, gmx = common.compare(out[-m:], answer[-m:])
        return {"img_rel_l2": il2, "img_rel_max": imx,
                "grad_rel_l2": gl2, "grad_rel_max": gmx}
