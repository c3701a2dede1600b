"""Config-3/5 demo: 3D multicoil NUFFT CG-SENSE + many-slice sharded batch.

Phase 1 (config 3): single-volume 3D radial SENSE recon via the
Toeplitz-embedded normal operator (64^3 by default; pass --big for 128^3),
whose CG runs kernel K1 on the card.
Phase 2 (config 5): a batch of slices solved jointly, sharded over a
(slice, coil) mesh when the script runs in a ``torch.distributed`` group of
two or more ranks (``torchrun``), else on the one device.

Run: python -m indigo_tpu_torch.examples.multicoil_3d [--big] [--cpu]
"""
import time

import numpy as np
import torch
import torch.distributed as dist

import indigo_tpu_torch as it
from indigo_tpu_torch.examples._common import cli, device_of, sync
from indigo_tpu_torch.models import sense_nufft_op
from indigo_tpu_torch.parallel import make_mesh, sense_batch_recon
from indigo_tpu_torch.toeplitz import toeplitz_kernel
from indigo_tpu_torch.utils import rel_err


def kooshball(nspokes, nread, rng):
    u, v = rng.random(nspokes), rng.random(nspokes)
    th = np.arccos(2 * u - 1)
    ph = 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def make_problem(n, nc, nspokes, rng):
    """The kooshball, the coil maps and the Gaussian-blob volume."""
    traj = kooshball(nspokes, n, rng)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    maps = np.asarray([
        (0.4 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2 + (zz - c) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b, c in rng.random((nc, 3))], dtype=np.complex64)
    x_true = (np.exp(-(((xx - .5) ** 2 + (yy - .5) ** 2 + (zz - .5) ** 2) * 9))
              ).astype(np.complex64).ravel()
    return traj, maps, x_true


def main(n=None, nc=8, big=False, device=None):
    dev = device_of(device)
    n = n or (128 if big else 64)
    rng = np.random.default_rng(0)
    img_shape = (n, n, n)
    traj, maps, x_true = make_problem(n, nc, 8192 if big else 4096, rng)

    # density compensation folded into the normal equations: solve
    # A^H W A x = A^H W y, the standard cure for radial CG's
    # density-induced ill-conditioning. On the card Pipe-Menon runs the
    # G G^H fixed point through the KB gather and its index_add_ adjoint
    # (seconds at this scale); on the CPU the analytic |k|^2 ramp stands in
    # (the host CSR fixed point would take minutes at 3D scale).
    if dev.type != "cpu":
        t0 = time.time()
        wdcf = it.noncart.pipe_menon_dcf(traj, tuple(
            int(2 * round(s * 1.25 / 2)) for s in img_shape),
            width=4, iters=20, impl="device", device=dev)
        dcf = "pipe_menon"
        print(f"pipe-menon DCF (device) in {time.time()-t0:.1f}s")
    else:
        wdcf = (np.sum(traj ** 2, axis=1) + (0.5 / n) ** 2).astype(
            np.float32)
        wdcf /= wdcf.max()
        dcf = "ramp"

    t0 = time.time()
    Tf = toeplitz_kernel(traj, img_shape, oversamp=1.25, width=4,
                         weights=wdcf, device=dev)
    print(f"toeplitz kernel ({Tf.shape}) built in {time.time()-t0:.1f}s")

    # full gridded 3D SENSE operator; simulate k-space and form
    # rhs = A^H W y on the device
    t0 = time.time()
    A, plan = sense_nufft_op(traj, maps, oversamp=1.25, width=4, device=dev)
    print(f"gridded SENSE operator built in {time.time()-t0:.1f}s:")
    print("  " + A.dump().splitlines()[0])
    t0 = time.time()
    y = A * x_true
    # y is in the plan's (cell-sorted) sample order: permute weights to match
    w = torch.from_numpy(np.tile(wdcf[plan.perm], nc)).to(dev)
    rhs = (A.H * (w * y)[:, None])[:, 0][None, :]
    print(f"forward + adjoint (k-space sim + rhs) in {time.time()-t0:.1f}s; "
          f"|y|={float(torch.linalg.vector_norm(y)):.3e}")

    maps_d = torch.from_numpy(maps).to(dev)
    Tf_d = torch.from_numpy(Tf).to(dev)
    lam = 1e-3 * float(rhs.abs().max())
    t0 = time.time()
    xs, resids = sense_batch_recon(Tf_d, maps_d, rhs, mesh=None, lamda=lam,
                                   iters=40)
    sync(dev)
    t_single = time.time() - t0
    r = resids.cpu().numpy()
    x0 = xs[0]
    dc = rel_err(A * x0, y)
    err = rel_err(x0, x_true)
    drop = r[0, 0] / max(r[-1, 0], 1e-30)
    print(f"config-3 single volume: first call {t_single:.1f}s, "
          f"rel_err vs truth = {err:.2e}, data consistency = {dc:.2e}, "
          f"resid drop {drop:.1e}x over 40 iters")

    # ---- config 5: many-slice batch, sharded if ranks allow -------------
    S = 4
    rhs_batch = torch.cat([rhs * (s + 1) for s in range(S)], dim=0)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if ranks >= 2:
        coil = 2
        mesh = make_mesh(slice=min(S, ranks // coil), coil=coil,
                         device=dev if dev.type == "cpu" else None)
    t0 = time.time()
    xs_b, _ = sense_batch_recon(Tf_d, maps_d, rhs_batch, mesh=mesh,
                                lamda=lam, iters=40)
    sync(dev)
    t_batch = time.time() - t0
    print(f"config-5 batch S={S} mesh={mesh and dict(mesh.shape)}: "
          f"{t_batch:.1f}s")
    errs = []
    for s in range(S):
        # CG iterates are exactly scale-equivariant; tolerance covers f32
        # rounding at this problem's ~1e9 dynamic range
        e = rel_err(xs_b[s], (s + 1) * xs[0])
        errs.append(e)
        assert e < 1e-3, f"slice {s} mismatch {e}"
    print("slice linearity check OK")
    return {"device": str(dev), "n": n, "nc": nc, "dcf": dcf,
            "samples": plan.n_samples, "single_s": t_single,
            "rel_err_vs_truth": err, "data_consistency": dc,
            "resid_drop": float(drop), "batch_s": t_batch, "ranks": ranks,
            "slice_linearity_max_err": max(errs)}


if __name__ == "__main__":
    main(**cli(__doc__, big=True))
