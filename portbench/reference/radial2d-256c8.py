"""Plain reference of the 2D radial sparse SENSE reconstruction.

The recipe x = cg(A^H A, A^H y, lamda, tol, maxiter) with A = G F Z D S
(``common.SenseNufft``: no density compensation), worked out from the
trajectory, the coil maps and the k-space alone.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common


class Reference:
    def __init__(self, cfg, traj, maps, precision, device):
        self.cfg, self.precision = cfg, precision
        with common.matmul_precision(precision):
            self.A = common.SenseNufft(traj, maps, cfg["oversamp"],
                                       cfg["width"], precision, device)

    def normal(self, x):
        return self.A.adjoint(self.A.forward(x))

    def rhs(self, y):
        y = torch.as_tensor(np.asarray(y)).to(self.A.device, self.A.cdt)
        return self.A.adjoint(y.reshape(self.A.maps.shape[0], -1))

    def image(self, y):
        """The recipe's reconstruction of k-space y (user order,
        coil-major), by ``maxiter`` CG steps in this precision."""
        cfg = self.cfg
        with common.matmul_precision(self.precision):
            return common.cg(self.normal, self.rhs(y), float(cfg["lamda"]),
                             int(cfg["maxiter"]), float(cfg["tol"]))

    def answer(self, y):
        with common.matmul_precision(self.precision):
            return self.rhs(y)

    def numbers(self, y, b, image):
        """The residual of the program's image in the normal equations the
        reference builds: ||(A^H A + lamda I) x - A^H y|| / ||A^H y||.

        Not the gap to the reference's own CG image: at lamda 0.1 the
        system's condition number is ~1e7, and 50 float32 CG steps amplify
        rounding so far that a float32 run of this reference lands within
        a factor of three of the gap a TF32 run reads, too close for a
        limit between them, while their residuals stay six times apart."""
        lam = float(self.cfg["lamda"])
        with common.matmul_precision(self.precision):
            x = torch.tensor(np.asarray(image)).to(
                self.A.device, self.A.cdt).reshape(self.A.img)
            r = self.normal(x) + lam * x - b
            return {"normal_residual": float(torch.linalg.vector_norm(r)
                                             / torch.linalg.vector_norm(b))}
