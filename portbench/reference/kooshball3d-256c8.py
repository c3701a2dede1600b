"""Plain reference of the 3D kooshball SENSE reconstruction.

The configuration's semantics, worked out from the trajectory, the coil
maps and the k-space alone (``common`` holds the conventions):

  * radial density compensation w = |k|^(d-1) + (1/(2 max N))^(d-1),
    scaled to a largest weight of 1;
  * the Toeplitz spectrum of the normal operator: the weights gridded onto
    the oversampled grid of the doubled image (2N), transformed back to
    image space unnormalised, cropped to 2N about its centre, deapodized,
    and transformed forward from the centre; its real part;
  * lamda: the configuration's, else 1e-3 of the spectrum's largest
    magnitude, floored at the gridding-error scale 10^(1 - width) (three
    times that below 1.25x oversampling) of it;
  * the right-hand side b = A^H W y;
  * the normal operator x -> sum_c conj(s_c) T (s_c x), T the circular
    convolution of the corner-embedded 2N volume with the spectrum;
  * ``iters`` steps of CG on (normal + lamda I) x = b from 0.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common


class Reference:
    def __init__(self, cfg, traj, maps, precision, device):
        self.cfg, self.precision = cfg, precision
        with common.matmul_precision(precision):
            self.A = A = common.SenseNufft(traj, maps, cfg["oversamp"],
                                           cfg["width"], precision, device)
            d = len(A.img)
            k2 = torch.sum(A.traj ** 2, dim=1)
            w = k2 ** ((d - 1) / 2.0) + (0.5 / max(A.img)) ** (d - 1)
            self.w = (w / w.max()).to(A.rdt)
            self.Tf = self._spectrum()
            tmax = float(self.Tf.abs().max())
            width, os_ = cfg["width"], cfg["oversamp"]
            floor = 10.0 ** (1 - width) * (3.0 if os_ < 1.25 else 1.0)
            lam = cfg.get("lamda")
            self.lamda = (max(1e-3, floor) * tmax if lam is None
                          else float(lam))
            self.P = [common.padded_dft(n, precision, A.device)
                      for n in A.img]
            self.PH = [common.padded_dft(n, precision, A.device,
                                         inverse=True) for n in A.img]

    def _spectrum(self):
        A, cfg = self.A, self.cfg
        big = tuple(2 * n for n in A.img)
        grid2 = tuple(common.grid_size(b, cfg["oversamp"]) for b in big)
        idx, wts = common.kb_taps(A.traj, grid2, cfg["width"], A.beta, A.rdt)
        v = common.scatter(self.w.to(A.cdt), idx, wts, int(np.prod(grid2)))
        del idx, wts
        u = v.reshape(grid2)
        for ax, (b, g) in enumerate(zip(big, grid2)):
            u = common.apply_axis(u, common.centred_dft(
                b, g, self.precision, A.device, adjoint=True), ax,
                self.precision)
        deapod = torch.from_numpy(common.outer(
            [common.deapod_1d(b, g, cfg["width"], A.beta)
             for b, g in zip(big, grid2)])).to(A.device, A.rdt)
        t = u * deapod
        del u
        for ax, b in enumerate(big):
            t = common.apply_axis(t, common.shifted_dft(
                b, self.precision, A.device), ax, self.precision)
        return t.real.contiguous()

    def normal(self, x):
        A = self.A
        out = torch.zeros_like(x)
        for c in range(A.maps.shape[0]):
            v = A.maps[c] * x
            for ax, P in enumerate(self.P):
                v = common.apply_axis(v, P, ax, self.precision)
            v = v * self.Tf
            for ax, P in enumerate(self.PH):
                v = common.apply_axis(v, P, ax, self.precision)
            out += A.maps[c].conj() * v
        return out

    def rhs(self, y):
        y = torch.as_tensor(np.asarray(y)).to(self.A.device, self.A.cdt)
        return self.A.adjoint(self.w * y.reshape(self.A.maps.shape[0], -1))

    def answer(self, y):
        """The reconstruction of k-space y (user order, coil-major)."""
        with common.matmul_precision(self.precision):
            return common.cg(self.normal, self.rhs(y), self.lamda,
                             int(self.cfg["iters"]),
                             float(self.cfg.get("tol", 0.0)))

    image = answer

    @staticmethod
    def numbers(y, answer, image):
        """The program's image against the reference's: the relative l2
        gap, and the largest gap over the largest reference value."""
        l2, mx = common.compare(image, answer)
        return {"img_rel_l2": l2, "img_rel_max": mx}
