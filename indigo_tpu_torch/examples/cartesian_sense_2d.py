"""Config-1 demo: 2D Cartesian single-coil CG-SENSE recon, 128x128.

Builds A = P F D (sampling mask, FFT, apodization-like diagonal), fuses
the normal equations with the tree optimizer and solves them with CG on the
device. Compares against a numpy direct least-squares solve on a small
problem, and reports timing for the full size.

Run: python -m indigo_tpu_torch.examples.cartesian_sense_2d [--cpu]
"""
import time

import numpy as np
import scipy.sparse as sp

import indigo_tpu_torch as it
from indigo_tpu_torch.examples._common import cli, device_of, sync


def make_problem(n, accel=2, rng=None):
    rng = np.random.default_rng(rng)
    # variable-density Cartesian undersampling: keep center + every accel-th
    keep = np.zeros(n, dtype=bool)
    keep[::accel] = True
    keep[n // 2 - n // 8: n // 2 + n // 8] = True
    rows = np.flatnonzero(np.repeat(keep, n))
    P = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (np.arange(len(rows)), rows)),
        shape=(len(rows), n * n),
    )
    # smooth "sensitivity"-like diagonal
    yy, xx = np.mgrid[0:n, 0:n] / n
    d = (0.5 + np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) * 4)).astype(np.complex64)
    # Shepp-Logan-ish phantom: sum of ellipses
    img = np.zeros((n, n), np.complex64)
    for cx, cy, rx, ry, amp in [(0.5, 0.5, 0.35, 0.45, 1.0),
                                (0.45, 0.5, 0.1, 0.15, -0.5),
                                (0.6, 0.4, 0.08, 0.06, 0.7)]:
        m = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
        img[m] += amp
    return P, d.ravel(), img.ravel()


def main(n=128, device=None):
    dev = device_of(device)
    P, d, x_true = make_problem(n, rng=0)
    A = (it.SpMatrix(P, device=dev) * it.UnscaledFFT((n, n), device=dev)
         * it.Diag(d, device=dev))
    A = A.optimize()
    print("operator tree:")
    print(A.dump())

    y = A * x_true  # simulated k-space, on the device
    # optimize() fuses P^H P (the 0/1 sampling matrix's normal factor) into
    # one diagonal via host spGEMM: no gathers/SpMM left in the CG loop
    AHA = (A.H * A).optimize()
    AHy = A.H * y

    t0 = time.perf_counter()
    x, info = it.cg(AHA, AHy, lamda=1e-6, tol=1e-8, maxiter=100)
    sync(dev)
    t_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    x, info = it.cg(AHA, AHy, lamda=1e-6, tol=1e-8, maxiter=100)
    sync(dev)
    t_warm = time.perf_counter() - t0

    iters = int(info["iters"])
    resid = float(info["resid"])
    # Undersampled single-coil => normal equations are singular; the
    # meaningful accuracy metric is data consistency ||Ax - y|| / ||y||.
    dc = it.utils.rel_err(A * x, y)
    print(f"device={dev.type} n={n} "
          f"cg_iters={iters} resid={resid:.2e} data_consistency={dc:.2e}")
    print(f"first_call={t_first:.3f}s warm_solve={t_warm:.3f}s "
          f"({iters / max(t_warm, 1e-9):.1f} CG iters/sec)")

    # Small-problem cross-check: regularized normal equations vs a numpy
    # direct solve (well-posed, unique solution).
    ns, lam = 16, 1.0
    Ps, ds, xs = make_problem(ns, rng=0)
    Fs = np.fft.fftn(np.eye(ns * ns, dtype=np.complex64)
                     .reshape(ns, ns, -1), axes=(0, 1)).reshape(ns * ns, -1)
    Adense = Ps.toarray() @ Fs @ np.diag(ds)
    As = (it.SpMatrix(Ps, device=dev)
          * it.UnscaledFFT((ns, ns), device=dev) * it.Diag(ds, device=dev))
    ys = As * xs
    rhs = As.H * ys
    xd = np.linalg.solve(
        Adense.conj().T @ Adense + lam * np.eye(ns * ns), rhs.cpu().numpy())
    xj, _ = it.cg(As.H * As, rhs, lamda=lam, tol=1e-8, maxiter=500)
    xerr = it.utils.rel_err(xj, xd)
    print(f"small-problem check vs numpy direct solve: rel_err={xerr:.2e}")
    assert xerr < 1e-4, "CG disagrees with numpy direct solve"
    assert dc < 1e-3, "poor data consistency on the large problem"
    print("OK")
    return {"device": str(dev), "n": n, "cg_iters": iters, "resid": resid,
            "data_consistency": dc, "first_s": t_first, "warm_s": t_warm,
            "cg_iters_per_s": iters / max(t_warm, 1e-9),
            "small_rel_err": xerr}


if __name__ == "__main__":
    main(**cli(__doc__))
