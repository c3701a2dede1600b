"""Config-2 demo: 2D radial NUFFT SENSE recon, 8 coils.

Builds A = KronI(8, G Fc Z) . VStack(Diag maps) with the sparse gridding
matrix G (an SpMatrix: kernel K3 on the card), simulates radial k-space,
solves the regularized normal equations with CG on the device, and
cross-checks a small problem against a float64 numpy direct solve.

Run: python -m indigo_tpu_torch.examples.radial_sense_2d [--cpu]
"""
import time

import numpy as np

import indigo_tpu_torch as it
from indigo_tpu_torch.examples._common import cli, device_of, sync
from indigo_tpu_torch.models import sense_nufft_op
from indigo_tpu_torch.utils import rand64c, rel_err


def radial_traj(nspokes, nread):
    ang = np.pi * np.arange(nspokes) / nspokes
    r = (np.arange(nread) - nread // 2) / nread
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def smooth_maps(nc, shape, rng):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    maps = []
    for c in range(nc):
        ph = 2 * np.pi * (rng.random() * xx / shape[1]
                          + rng.random() * yy / shape[0])
        amp = 0.4 + np.exp(-(((xx / shape[1]) - rng.random()) ** 2
                             + ((yy / shape[0]) - rng.random()) ** 2) * 3)
        maps.append(amp * np.exp(1j * ph))
    return np.asarray(maps, dtype=np.complex64)


def phantom(shape):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    xx = xx / shape[1]
    yy = yy / shape[0]
    img = np.zeros(shape, np.complex64)
    for cx, cy, rx, ry, amp in [(0.5, 0.5, 0.35, 0.45, 1.0),
                                (0.45, 0.5, 0.1, 0.15, -0.5),
                                (0.6, 0.4, 0.08, 0.06, 0.7)]:
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] += amp
    return img


def main(n=128, nc=8, device=None):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    img_shape = (n, n)
    traj = radial_traj(int(n * 1.5), 2 * n)
    maps = smooth_maps(nc, img_shape, rng)
    x_true = phantom(img_shape).ravel()

    # the config-2 recipe grids with the sparse matrix (the reference's
    # ragged-block SpMM; K3 here), which "auto" would replace by tiles
    A, plan = sense_nufft_op(traj, maps, oversamp=1.5, width=4,
                             interp="sparse", device=dev)
    print(A.dump())
    print(f"samples={plan.n_samples} coils={nc} grid={plan.grid_shape}")

    y = A * x_true
    lam = 1e-1
    AHy = A.H * y
    AHA = A.H * A

    t0 = time.perf_counter()
    x, info = it.cg(AHA, AHy, lamda=lam, tol=1e-7, maxiter=50)
    sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = it.cg(AHA, AHy, lamda=lam, tol=1e-7, maxiter=50)
    sync(dev)
    t_warm = time.perf_counter() - t0

    iters = int(info["iters"])
    dc = rel_err(A * x, y)
    err = rel_err(x, x_true)
    print(f"device={dev.type} n={n} cg_iters={iters} "
          f"resid={float(info['resid']):.2e} img_rel_err={err:.2e} "
          f"data_consistency={dc:.2e}")
    print(f"first={t_first:.2f}s warm={t_warm:.3f}s "
          f"({iters / max(t_warm, 1e-9):.1f} CG iters/sec)")

    # small cross-check vs float64 direct solve of the same operator
    ns = 16
    traj_s = radial_traj(24, 32)
    maps_s = smooth_maps(3, (ns, ns), rng)
    As, _ = sense_nufft_op(traj_s, maps_s, oversamp=2.0, width=6,
                           interp="sparse", device=dev)
    xs = rand64c(ns * ns, rng=rng)
    ys = As * xs
    Ad = As.to_dense().cpu().numpy().astype(np.complex128)
    lam_s = 10.0
    xd = np.linalg.solve(Ad.conj().T @ Ad + lam_s * np.eye(ns * ns),
                         Ad.conj().T @ ys.cpu().numpy().astype(np.complex128))
    xj, _ = it.cg(As.H * As, As.H * ys, lamda=lam_s, tol=1e-9, maxiter=300)
    xerr = rel_err(xj, xd)
    print(f"small-problem check vs float64 direct solve: rel_err={xerr:.2e}")
    assert xerr < 2e-4, "CG disagrees with numpy direct solve"
    print("OK")
    return {"device": str(dev), "n": n, "nc": nc,
            "samples": plan.n_samples, "cg_iters": iters,
            "resid": float(info["resid"]), "img_rel_err": err,
            "data_consistency": dc, "first_s": t_first, "warm_s": t_warm,
            "cg_iters_per_s": iters / max(t_warm, 1e-9),
            "small_rel_err": xerr}


if __name__ == "__main__":
    main(**cli(__doc__))
