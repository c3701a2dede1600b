"""2D radial sparse SENSE: the recipe of ``examples/radial_sense_2d.py``,
``cg(A.H * A, A.H * y, lamda, tol, maxiter)`` on the port's
``sense_nufft_op(interp="sparse")``.

The benchmark's inputs (trajectory, coil maps, phantoms and noisy k-space
of each slice, made from the seed on the device) and the program under test
called as a user of the port does: the slice's k-space in the trajectory's
order is sorted by the plan into the operator's order on the host, then
``A.H * y``, the recipe's ``cg``, and the image to host memory.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.inputs import simulate
from portbench.reference import common


def radial(cfg):
    """(M, 2) float64: ``spokes`` lines of ``readout`` points, at equal
    angles over pi."""
    ang = np.pi * np.arange(cfg["spokes"]) / cfg["spokes"]
    nread = cfg["readout"]
    r = (np.arange(nread) - nread // 2) / nread
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def coil_maps(shape, nc, gen, device):
    """Smooth coil sensitivities: a Gaussian bump around a random centre
    over a floor of 0.4, with a random linear phase (complex64)."""
    yy = (torch.arange(shape[0], device=device) / shape[0])[:, None]
    xx = (torch.arange(shape[1], device=device) / shape[1])[None, :]
    p = torch.rand((nc, 4), generator=gen, device=device)
    maps = torch.empty((nc,) + tuple(shape), dtype=torch.complex64,
                       device=device)
    for c in range(nc):
        amp = 0.4 + torch.exp(-3 * ((xx - p[c, 2]) ** 2
                                    + (yy - p[c, 3]) ** 2))
        maps[c] = torch.polar(amp, 2 * math.pi * (p[c, 0] * xx
                                                  + p[c, 1] * yy))
    return maps


def phantom(shape, gen, device, ellipses=4):
    """Piecewise-constant ellipses inside a head outline, their centres,
    axes and intensities drawn from the seed (complex64)."""
    yy = (torch.arange(shape[0], device=device) / shape[0])[:, None]
    xx = (torch.arange(shape[1], device=device) / shape[1])[None, :]
    img = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    img[((xx - 0.5) / 0.35) ** 2 + ((yy - 0.5) / 0.45) ** 2 <= 1] = 1.0
    p = torch.rand((ellipses, 5), generator=gen, device=device)
    for q in p:
        cx, cy = 0.35 + 0.3 * q[0], 0.3 + 0.4 * q[1]
        rx, ry = 0.04 + 0.1 * q[2], 0.04 + 0.1 * q[3]
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] += (
            q[4] - 0.5)
    return img.to(torch.complex64)


class System:
    def __init__(self, cfg, seed, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.shape = tuple(cfg["image"])
        self.traj = radial(cfg)
        self.maps = coil_maps(self.shape, cfg["coils"], self.gen,
                              self.device).cpu().numpy()
        self.A = self.N = self.plan = None

    def make_pool(self, count):
        """``count`` slices, numpy complex64 (nc * M,), coil-major in the
        trajectory's order."""
        A = common.SenseNufft(self.traj, self.maps, self.cfg["oversamp"],
                              self.cfg["width"], "float32", self.device)
        pool = []
        with common.matmul_precision("float32"):
            for _ in range(count):
                x = phantom(self.shape, self.gen, self.device)
                y = simulate(A, x, self.cfg["noise"], self.gen)
                pool.append(y.reshape(-1).cpu().numpy())
        return pool

    def build(self):
        from indigo_tpu_torch.models.sense import sense_nufft_op
        c = self.cfg
        self.A, self.plan = sense_nufft_op(
            self.traj, self.maps, oversamp=c["oversamp"], width=c["width"],
            interp=c["interp"], device=self.device)
        self.N = self.A.H * self.A

    def serve(self, y):
        """One slice: k-space in the trajectory's order in, the image in
        host memory (numpy) out."""
        from indigo_tpu_torch import cg
        c = self.cfg
        b = self.A.H * self.plan.sort_samples(y, ncoil=c["coils"])
        x, _ = cg(self.N, b, lamda=c["lamda"], tol=c["tol"],
                  maxiter=c["maxiter"])
        return x.cpu().numpy().reshape(self.shape)

    def counters(self):
        from indigo_tpu_torch.ops import spmm
        from indigo_tpu_torch.ops.ell_spmm import (ell_spmm_cuda,
                                                   jag_spmm_cuda)
        return {"k3_launches": jag_spmm_cuda.launches,
                "k4_launches": ell_spmm_cuda.launches,
                "plain_spmm_on_card": spmm.plain_cuda_calls}

    def free(self):
        self.A = self.N = self.plan = None
