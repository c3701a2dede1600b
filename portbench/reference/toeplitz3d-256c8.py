"""Plain reference of the 3D CG-SENSE operator-tree recipe.

The configuration's semantics, worked out from the trajectory, the coil
maps and the k-space alone (``common`` holds the conventions; the
spectrum, the normal operator x -> sum_c conj(s_c) T (s_c x), the rhs and
CG are ``kooshball3d-256c8``'s reference's, reused by import):

  * Pipe-Menon density compensation: w = 1, then ``dcf_iters`` times
    w <- w / |G G^H w|, G the Kaiser-Bessel interpolation of ``width``
    nodes onto the oversampled grid of the image (320^3 at 256^3), then
    scaled to a largest weight of 1;
  * the Toeplitz spectrum of the normal operator with those weights;
  * lamda: the configuration's, else max(1e-3, 10^(1 - width)) of the
    spectrum's largest magnitude (three times the floor below 1.25x
    oversampling);
  * the right-hand side b = A^H W y and ``iters`` steps of CG on
    (normal + lamda I) x = b from 0.

Departures from the published recipe: the density compensation's kernel
takes Beatty's beta for 2x oversampling, as the recipe's
``pipe_menon_dcf`` does when it is given no beta (the NUFFT's own kernel
takes the beta of its 1.25x grid), as the port and the JAX package run
it.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import spec
from portbench.reference import common

koosh = spec.module("reference", "kooshball3d-256c8")


def pipe_menon(A, cfg):
    """The weights (M,) in A's real dtype, largest 1."""
    width = cfg["width"]
    idx, wts = common.kb_taps(A.traj, A.grid, width,
                              common.beatty_beta(width, 2.0), A.rdt)
    n_grid = int(np.prod(A.grid))
    w = torch.ones(A.traj.shape[0], dtype=A.rdt, device=A.device)
    for _ in range(int(cfg["dcf_iters"])):
        d = common.gather(common.scatter(w.to(A.cdt), idx, wts, n_grid),
                          idx, wts)
        w = w / torch.clamp(d.abs(), min=1e-12)
    return w / w.max()


class Reference(koosh.Reference):
    def __init__(self, cfg, traj, maps, precision, device):
        self.cfg, self.precision = cfg, precision
        with common.matmul_precision(precision):
            self.A = A = common.SenseNufft(traj, maps, cfg["oversamp"],
                                           cfg["width"], precision, device)
            self.w = pipe_menon(A, cfg)
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
