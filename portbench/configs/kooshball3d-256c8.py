"""3D kooshball SENSE through ``indigo_tpu_torch.models.SenseRecon``.

The benchmark's inputs for this configuration (the trajectory, coil maps,
phantoms and noisy k-space, all made from the seed on the device) and the
program under test built and called as a user of the port does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.inputs import simulate
from portbench.reference import common


def kooshball(cfg):
    """(M, 3) float64: ``spokes`` radial lines of ``readout`` points
    through the centre, their directions uniform on the sphere from the
    configuration's ``trajectory_seed`` (the geometry is the scanner's, not
    the seed's)."""
    rng = np.random.default_rng(cfg["trajectory_seed"])
    u, v = rng.random(cfg["spokes"]), rng.random(cfg["spokes"])
    th, ph = np.arccos(2 * u - 1), 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    nread = cfg["readout"]
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def axes(shape, device):
    """Per-axis coordinates in [0, 1), shaped to broadcast."""
    d = len(shape)
    return [(torch.arange(n, device=device, dtype=torch.float32) / n)
            .reshape([n if k == a else 1 for k in range(d)])
            for a, n in enumerate(shape)]


def coil_maps(shape, nc, gen, device):
    """Smooth coil sensitivities: a Gaussian bump around a random centre
    over a floor of 0.4, with a random linear phase (complex64)."""
    x = axes(shape, device)
    p = torch.rand((nc, len(shape)), generator=gen, device=device)
    maps = torch.empty((nc,) + tuple(shape), dtype=torch.complex64,
                       device=device)
    for c in range(nc):
        r2 = sum((x[a] - p[c, a]) ** 2 for a in range(len(shape)))
        phase = 2 * math.pi * (p[c, 0] * x[-1] + p[c, 1] * x[-2])
        maps[c] = torch.polar(0.4 + torch.exp(-3 * r2), phase)
    return maps


def phantom(shape, gen, device):
    """A smooth head-like object: a broad Gaussian and a small bright one,
    their centres and widths drawn from the seed (complex64)."""
    x = axes(shape, device)
    p = torch.rand((2, len(shape) + 1), generator=gen, device=device)
    img = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for k, (amp, lo, hi) in enumerate(((1.0, 6.0, 12.0), (0.5, 40.0, 80.0))):
        c = 0.35 + 0.3 * p[k, :-1]
        r2 = sum((x[a] - c[a]) ** 2 for a in range(len(shape)))
        img += amp * torch.exp(-(lo + (hi - lo) * p[k, -1]) * r2)
    return img.to(torch.complex64)


class System:
    def __init__(self, cfg, seed, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.shape = tuple(cfg["image"])
        self.traj = kooshball(cfg)
        self.maps = coil_maps(self.shape, cfg["coils"], self.gen,
                              self.device).cpu().numpy()
        self.recon = None

    def make_pool(self, count):
        """``count`` acquisitions, numpy complex64 (nc * M,), coil-major
        in the trajectory's order, as a scanner hands them over."""
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
        from indigo_tpu_torch.models import SenseRecon
        c = self.cfg
        self.recon = SenseRecon(
            self.traj, self.maps, oversamp=c["oversamp"], width=c["width"],
            lamda=c["lamda"], iters=c["iters"], tol=c["tol"], dcf=c["dcf"],
            coil_chunk=c["coil_chunk"], device=self.device)

    def serve(self, y):
        """One request as a user at the scanner makes it: k-space in, the
        image in host memory (numpy) out."""
        return self.recon(y)

    def counters(self):
        from indigo_tpu_torch.ops import spmm
        from indigo_tpu_torch.ops.dft_cuda import (sense_normal_cuda,
                                                   sense_normal_reference)
        return {"k1_launches": sense_normal_cuda.launches,
                "plain_normal_op_on_card": sense_normal_reference.cuda_calls,
                "plain_spmm_on_card": spmm.plain_cuda_calls}

    def free(self):
        self.recon = None
