"""Dry run of every sharded path on tiny shapes, each held to its
single-device answer:

    python -m indigo_tpu_torch.parallel.dryrun 8 cpu     # 8 gloo ranks
    python -m indigo_tpu_torch.parallel.dryrun 4         # 4 ranks on the GPU(s)

The port's counterpart of the reference's ``dryrun_multichip(n)``: a
(slice, coil) mesh solve, the distributed FFT, the slab and pencil
volume-sharded solves, and the end-to-end ``SenseReconSharded`` with and
without grid auto-padding. Every comparison is asserted; the auto-padded
pipeline is held to a single-device solve on the same padded grid
(``recon_at_grid``).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip", "dryrun_ranks", "recon_at_grid"]


def recon_at_grid(traj, maps, y, grid_shape, oversamp=1.25, width=4,
                  lamda=0.0, iters=30, dcf="radial", device=None):
    """Single-device CG-SENSE with the rhs gridded on ``grid_shape`` (which
    ``SenseRecon`` derives from ``oversamp`` alone): ``GridDFT`` adjoint,
    deapodised coil combine, ``sense_batch_recon``. What an auto-padded
    ``SenseReconSharded`` is compared with. ``device``: default the card
    (raises where there is none); pass ``"cpu"`` to run on the host.
    Returns the image (numpy)."""
    from ..noncart import beatty_beta, deapodization
    from ..operators import GridDFT
    from ..ops.tile_interp import plan_tile_interp
    from ..toeplitz import toeplitz_kernel
    from .e2e import _dcf_weights
    from .recon import sense_batch_recon

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "recon_at_grid: no CUDA device; pass device='cpu' to run "
                "the solve on the host")
        device = "cuda"
    traj = np.asarray(traj, np.float64)
    maps = np.asarray(maps, np.complex64)
    nc, img = maps.shape[0], maps.shape[1:]
    beta = beatty_beta(width, oversamp)
    w = _dcf_weights(dcf, traj, img, grid_shape, width, beta, device)
    G = GridDFT(plan_tile_interp(traj, grid_shape, width=width, beta=beta),
                img, device=device)
    wy = torch.from_numpy(np.ascontiguousarray(
        (w[None] * np.asarray(y).reshape(nc, -1)).T, np.complex64))
    u = G.apply(wy.to(device), adjoint=True)                  # (n, nc)
    dam = deapodization(img, grid_shape, width=width, beta=beta)[None] * maps
    dam = torch.from_numpy(dam.reshape(nc, -1).astype(np.complex64))
    rhs = torch.sum(dam.to(device).conj().T * u, dim=1)[None]
    Tf = toeplitz_kernel(traj, img, oversamp=oversamp, width=width,
                         weights=w, warn=False, device=device)
    xs, _ = sense_batch_recon(torch.from_numpy(Tf).to(device),
                              torch.from_numpy(maps).to(device), rhs,
                              lamda=lamda, iters=iters)
    return xs[0].reshape(img).cpu().numpy()


def _kooshball(nspokes, nread):
    g = (1 + 5 ** 0.5) / 2
    i = np.arange(nspokes)
    z = (2 * i + 1) / nspokes - 1
    th = 2 * np.pi * i / g
    dirs = np.stack([z, np.sqrt(1 - z * z) * np.cos(th),
                     np.sqrt(1 - z * z) * np.sin(th)], 1)
    r = (np.arange(nread) + 0.5) / nread * 0.5
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def dryrun_ranks(n_devices, device):
    """The body every rank runs; returns the relative errors (rank 0's)."""
    from ..models import SenseRecon
    from ..toeplitz import toeplitz_kernel
    from ..utils import rand64c, rel_err
    from . import (SenseReconSharded, fftn_sharded, make_mesh,
                   sense_batch_recon, sense_vol_recon, sense_vol_recon2)

    dev = None if device == "cuda" else device
    rng = np.random.default_rng(0)
    coil = 2 if n_devices % 2 == 0 else 1
    sl = n_devices // coil
    mesh = make_mesh(device=dev, slice=sl, coil=coil)
    place = mesh.device
    err = {}

    def check(key, value, bound=1e-4):
        err[key] = float(value)
        if not value < bound:
            raise AssertionError(f"{key}: rel_err {value:.3e} >= {bound}")

    # tiny shapes: S slices, nc coils, 8x8 image
    S, nc, n = 2 * sl, 2 * coil, 8
    traj = rng.random((40, 2)) - 0.5
    maps = rand64c(nc, n, n, rng=rng)
    Tf = toeplitz_kernel(traj, (n, n), oversamp=2.0, width=4, warn=False,
                         device=place)
    rhs = rand64c(S, n * n, rng=rng)
    xs, resids = sense_batch_recon(Tf, maps, rhs, mesh=mesh, lamda=1.0,
                                   iters=3)
    if tuple(xs.shape) != (S, n * n) or not bool(torch.isfinite(
            torch.view_as_real(xs)).all()):
        raise AssertionError("sharded batch recon: shape or non-finite")
    xs0, _ = sense_batch_recon(Tf, torch.from_numpy(maps).to(place), rhs,
                               lamda=1.0, iters=3)
    check("slice x coil recon", rel_err(xs, xs0))

    # the distributed FFT over the whole ring
    mesh1 = make_mesh(device=dev, x=n_devices)
    v = rand64c(2 * n_devices, 2 * n_devices, 4, rng=rng)
    check("distributed FFT", rel_err(fftn_sharded(v, mesh1, "x"),
                                     np.fft.fftn(v)))

    # ONE 3D volume in z slabs, the whole CG per rank
    img3 = (2 * n_devices, 2 * n_devices, 8)
    traj3 = rng.random((100, 3)) - 0.5
    maps3 = rand64c(2, *img3, rng=rng)
    Tf3 = toeplitz_kernel(traj3, img3, oversamp=2.0, width=4, warn=False,
                          device=place)
    lam3 = 0.05 * float(np.abs(Tf3).max())
    rhs3 = rand64c(*img3, rng=rng)
    mesh_v = make_mesh(device=dev, vol=n_devices)
    x_tp, _ = sense_vol_recon(Tf3, maps3, rhs3, mesh_v, lamda=lam3, iters=3)
    x_tp0, _ = sense_batch_recon(Tf3, torch.from_numpy(maps3).to(place),
                                 rhs3.reshape(1, -1), lamda=lam3, iters=3)
    check("slab volume recon", rel_err(x_tp.ravel(), x_tp0[0]))
    if n_devices % 2 == 0:
        mesh_p = make_mesh(device=dev, vz=n_devices // 2, vy=2)
        x_pc, _ = sense_vol_recon2(Tf3, maps3, rhs3, mesh_p, lamda=lam3,
                                   iters=3)
        check("pencil volume recon", rel_err(x_pc.ravel(), x_tp0[0]))
        mesh_p.close()

    # END-TO-END: k-space in, image out, never gathering the volume
    n5 = 4 * n_devices
    sh5 = (n5, n5, n5)
    traj5 = _kooshball(2 * n5, n5)
    maps5 = (0.3 + 0.1 * rand64c(2, *sh5, rng=rng)).astype(np.complex64)
    kw5 = dict(oversamp=2.0, width=4, iters=3)
    rec_1 = SenseRecon(traj5, maps5, dcf="radial", device=place, **kw5)
    y5 = rec_1.simulate(rand64c(*sh5, rng=rng))
    rec_mesh = SenseReconSharded(traj5, maps5, mesh_v, dcf="radial", **kw5)
    check("e2e k-space->image recon", rel_err(rec_mesh(y5), rec_1(y5)))

    # a grid the mesh does not divide is auto-padded; held to the
    # single-device solve on that padded grid
    rec_pad = SenseReconSharded(traj5, maps5, mesh_v, dcf="radial",
                                oversamp=1.25, width=4, iters=3)
    if rec_pad.nt[0] % n_devices:
        raise AssertionError(f"auto-padded grid {rec_pad.grid_shape}")
    x_ref = recon_at_grid(traj5, maps5, y5, rec_pad.grid_shape,
                          oversamp=1.25, width=4, lamda=rec_pad.lamda,
                          iters=3, device=place)
    check("auto-padded e2e recon", rel_err(rec_pad(y5), x_ref))
    for m in {mesh, mesh1, mesh_v}:
        m.close()
    return err


def dryrun_multichip(n_devices=8, device="cuda", timeout=300.0):
    """Start ``n_devices`` ranks on this host and run every sharded path on
    them; prints one OK line and returns the errors."""
    from .launch import launch

    err = launch(dryrun_ranks, n_devices, args=(n_devices, device),
                 device=device, timeout=timeout)
    print(f"dryrun_multichip({n_devices}, {device}): OK ("
          + ", ".join(f"{k} err={v:.1e}" for k, v in err.items()) + ")")
    return err


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
