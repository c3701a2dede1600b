"""3D kooshball CG-SENSE written in the port's operator DSL, as indigo's
users write it (``examples/multicoil_3d.py``): Pipe-Menon density
compensation, the DCF-weighted Toeplitz spectrum, the gridded SENSE
operator for the rhs, and ``solvers.cg`` on the operator tree
``coils.H * KronI(nc, ToeplitzNormal) * coils`` (K2 on the card).

The inputs (trajectory, coil maps, phantoms and noisy k-space, made from
the seed) are ``kooshball3d-256c8``'s, loaded from its file. Per request
the only glue is the reorder of the k-space to the plan's sample order (one
device gather) and the weight multiply; everything else is a call into the
port.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import spec

koosh = spec.module("configs", "kooshball3d-256c8")


class System:
    def __init__(self, cfg, seed, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.shape = tuple(cfg["image"])
        self.inputs = koosh.System(cfg, seed, device)
        self.traj, self.maps = self.inputs.traj, self.inputs.maps
        self.A = self.N = self.perm = self.w = None

    def make_pool(self, count):
        """``count`` acquisitions, numpy complex64 (nc * M,), coil-major
        in the trajectory's order, as a scanner hands them over."""
        return self.inputs.make_pool(count)

    def build(self):
        """The recipe's set-up: Pipe-Menon weights on the oversampled grid,
        the spectrum with those weights, the gridded operator, the normal
        operator tree, and lamda by the recipe's rule."""
        from indigo_tpu_torch.models.sense import sense_nufft_op
        from indigo_tpu_torch.noncart import pipe_menon_dcf
        from indigo_tpu_torch.toeplitz import (sense_normal_toeplitz,
                                               toeplitz_kernel)
        from indigo_tpu_torch.utils import as_tensor
        c, dev = self.cfg, self.device
        os_, width = c["oversamp"], c["width"]
        grid = tuple(int(2 * round(n * os_ / 2)) for n in self.shape)
        w = pipe_menon_dcf(self.traj, grid, width=width,
                           iters=c["dcf_iters"], device=dev)
        Tf, info = toeplitz_kernel(self.traj, self.shape, oversamp=os_,
                                   width=width, weights=w, return_info=True,
                                   warn=False, device=dev)
        self.A, plan = sense_nufft_op(self.traj, self.maps, oversamp=os_,
                                      width=width, device=dev)
        self.N = sense_normal_toeplitz(Tf, self.maps, device=dev)
        eps = 10.0 ** (1 - width) * (3.0 if os_ < 1.25 else 1.0)
        self.lamda = (max(1e-3, eps) * info["max"] if c["lamda"] is None
                      else float(c["lamda"]))
        self.perm = torch.as_tensor(plan.perm, device=dev)
        self.w = as_tensor(np.tile(w[plan.perm], c["coils"]), dev)

    def serve(self, y):
        """One request: k-space (the trajectory's order) in through the
        port's boundary, rhs = A^H (w y) in the plan's order, ``cg`` on the
        tree, the image to host memory through the port's egress."""
        from indigo_tpu_torch import cg
        from indigo_tpu_torch.models.recon import host_array, host_copy
        from indigo_tpu_torch.utils import as_tensor
        c = self.cfg
        y = as_tensor(y, self.device).reshape(c["coils"], -1)[:, self.perm]
        b = self.A.H * (self.w * y.reshape(-1))
        x, _ = cg(self.N, b, lamda=self.lamda, tol=c["tol"],
                  maxiter=c["iters"])
        return host_array(host_copy(x.reshape(self.shape)))

    def counters(self):
        from indigo_tpu_torch.ops import spmm
        from indigo_tpu_torch.ops.dft_cuda import (sense_normal_cuda,
                                                   toeplitz_apply_cuda,
                                                   toeplitz_apply_reference)
        return {"k2_launches": toeplitz_apply_cuda.launches,
                "k1_launches": sense_normal_cuda.launches,
                "plain_toeplitz_on_card": toeplitz_apply_reference.cuda_calls,
                "plain_spmm_on_card": spmm.plain_cuda_calls}

    def free(self):
        self.A = self.N = self.perm = self.w = None
