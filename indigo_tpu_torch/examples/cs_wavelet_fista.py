"""Config-4 demo: l1-wavelet compressed-sensing recon via FISTA.

min_x 0.5 ||A x - y||^2 + lam ||W x||_1  with A a variable-density
undersampled Cartesian SENSE operator and W an orthogonal db4 DWT. Solved
in the wavelet domain (u = W x, x = W^H u) so the prox is plain complex
soft-thresholding; every FISTA step is enqueued on the device with no host
sync inside the loop.

Run: python -m indigo_tpu_torch.examples.cs_wavelet_fista [--cpu]
"""
import time

import numpy as np
import torch

import indigo_tpu_torch as it
from indigo_tpu_torch.examples._common import cli, device_of, sync
from indigo_tpu_torch.models import cartesian_sense_op
from indigo_tpu_torch.utils import rand64c, rel_err


def vardens_mask(shape, accel=4, center=0.08, rng=None):
    rng = np.random.default_rng(rng)
    ny, nx = shape
    p = 1.0 / (1.0 + 40.0 * np.abs(np.linspace(-0.5, 0.5, ny))) ** 1.0
    p = p / p.mean() / accel
    rows = rng.random(ny) < p
    rows[int(ny * (0.5 - center / 2)):int(ny * (0.5 + center / 2))] = True
    mask = np.zeros(shape, bool)
    mask[rows] = True
    return mask


def phantom(n):
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = np.zeros((n, n), np.complex64)
    for cx, cy, rx, ry, a in [(0.5, 0.5, 0.35, 0.45, 1.0),
                              (0.45, 0.5, 0.1, 0.15, -0.5),
                              (0.6, 0.4, 0.08, 0.06, 0.7),
                              (0.35, 0.6, 0.05, 0.09, 0.5)]:
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] += a
    return img


def coil_maps(n, nc):
    yy, xx = np.mgrid[0:n, 0:n] / n
    return np.asarray([
        (0.5 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b in [(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)][:nc]],
        dtype=np.complex64)


def main(n=128, nc=4, lam=2e-3, iters=100, device=None):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    img_shape = (n, n)
    maps = coil_maps(n, nc)
    mask = vardens_mask(img_shape, accel=3, rng=rng)
    A = cartesian_sense_op(mask, maps, device=dev)
    W = it.DWT(img_shape, wavelet="db4", levels=3, device=dev)
    x_true = phantom(n).ravel()
    y = A * x_true[:, None]
    noise = 0.01 * float(y.abs().mean())
    y = y + noise * torch.from_numpy(rand64c(*y.shape, rng=rng)).to(dev)

    L = float(it.max_eigen(A.H * A, n * n, iters=30)) * 1.05
    print(f"mask keeps {mask.mean():.0%} of k-space, {nc} coils, "
          f"L={L:.1f}")

    def gradf(u):
        x = W.apply(u, adjoint=True)
        r = A.apply(x) - y
        return W.apply(A.apply(r, adjoint=True))

    def proxg(v, a):
        return it.soft_thresh(v, lam * a)

    u0 = torch.zeros((n * n, 1), dtype=torch.complex64, device=dev)

    t0 = time.perf_counter()
    u, _ = it.apgd(gradf, proxg, 1.0 / L, u0, maxiter=iters)
    sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, _ = it.apgd(gradf, proxg, 1.0 / L, u0, maxiter=iters)
    sync(dev)
    t_warm = time.perf_counter() - t0
    x_img = (W.H * u)[:, 0].cpu().numpy()

    # zero-filled comparison
    x_zf = (A.H * y)[:, 0].cpu().numpy() / nc
    err_cs = rel_err(x_img, x_true)
    err_zf = rel_err(x_zf / max(abs(x_zf).max(), 1e-9) * abs(x_true).max(),
                     x_true)
    print(f"device={dev.type} FISTA {iters} iters: first={t_first:.2f}s "
          f"warm={t_warm:.2f}s ({iters/max(t_warm,1e-9):.1f} iters/sec)")
    print(f"rel_err: CS={err_cs:.3f}  zero-filled~={err_zf:.3f}")
    assert err_cs < err_zf, "CS recon should beat zero-filled"
    assert err_cs < 0.25
    print("OK")
    return {"device": str(dev), "n": n, "nc": nc, "iters": iters,
            "sampled_fraction": float(mask.mean()), "L": L,
            "first_s": t_first, "warm_s": t_warm,
            "iters_per_s": iters / max(t_warm, 1e-9),
            "rel_err_cs": err_cs, "rel_err_zero_filled": err_zf}


if __name__ == "__main__":
    main(**cli(__doc__))
