"""3D kooshball CG-SENSE through ``indigo_tpu_torch.models.SenseRecon``,
differentiated end to end as the data-consistency block of an unrolled
network in training.

One request is one training example: the k-space y goes to the card as a
leaf tensor that requires grad, ``x = recon(y, output="device")`` keeps
the graph, the loss L = 1/2 ||x - x_t||^2 against the fixed target x_t
runs its backward to y, and the image and dL/dy go to host memory as one
array ``[x.ravel(), dL/dy.ravel()]``.

The inputs (trajectory, coil maps, phantoms and noisy k-space, made from
the seed) are ``kooshball3d-256c8``'s, loaded from its file; the target is
one more phantom, made in set-up from the configuration's
``target_seed``.
"""
from __future__ import annotations

import torch

from portbench.lib import spec

koosh = spec.module("configs", "kooshball3d-256c8")


def target(cfg, device):
    """x_t (complex64, the image's shape): the benchmark's phantom drawn
    from ``target_seed``, the same on every run of one device type."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(cfg["target_seed"]))
    return koosh.phantom(tuple(cfg["image"]), gen, device)


class System(koosh.System):
    def __init__(self, cfg, seed, device):
        super().__init__(cfg, seed, device)
        self.xt = target(cfg, self.device)

    def serve(self, y):
        """One training step's block: k-space up as a leaf that requires
        grad, the reconstruction with its graph, the loss and its backward,
        and the image with the k-space gradient in host memory (numpy)."""
        from indigo_tpu_torch.models.recon import host_array, host_copy
        yg = torch.from_numpy(y).to(self.device).requires_grad_()
        x = self.recon(yg, output="device")
        d = torch.view_as_real(x - self.xt)
        (0.5 * torch.sum(d * d)).backward()
        return host_array(host_copy(torch.cat([x.reshape(-1), yg.grad])))

    def counters(self):
        from indigo_tpu_torch.ops.pad_dft_cuda import pad_idft_cuda
        from indigo_tpu_torch.ops.dft_cuda import sense_normal_cuda
        out = super().counters()
        out.update(k1_calls=sense_normal_cuda.plane_calls,
                   k1_backward_calls=sense_normal_cuda.backward_calls,
                   pad_idft_backward_calls=pad_idft_cuda.backward_calls)
        return out

    def free(self):
        super().free()
        self.xt = None
