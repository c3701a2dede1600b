"""Serving demo: build a `SenseRecon` pipeline once, reconstruct a stream.

The serving unit is the pipeline object: geometry, the Toeplitz spectrum
and every device buffer are built ONCE (`SenseRecon.__init__`), then each
acquisition costs one warm call, whose CG runs kernel K1 on the card.

Demonstrates
  * tolerance-stopped CG with the Jacobi (kernel-diagonal) preconditioner,
  * the sample-order-safe public boundary (y in the user's order),
  * ``output="device"`` delivery: the reconstructed volume stays on the
    card as a complex64 tensor; chain post-processing there, or copy it to
    the host when (and only when) the host needs the pixels.

Run: python -m indigo_tpu_torch.examples.serving_pipeline [--big] [--cpu]
     (64^3, --big = 128^3)
"""
import time

import numpy as np

from indigo_tpu_torch.examples._common import cli, device_of, sync
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.utils import rel_err


def kooshball(nspokes, nread, rng):
    u, v = rng.random(nspokes), rng.random(nspokes)
    th = np.arccos(2 * u - 1)
    ph = 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def make_problem(n, nc, rng):
    """The kooshball, the coil maps and the Gaussian-blob volume."""
    traj = kooshball(16 * n, n, rng)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    maps = np.asarray([
        (0.4 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2 + (zz - c) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b, c in rng.random((nc, 3))], dtype=np.complex64)
    x_true = np.exp(-(((xx - .5) ** 2 + (yy - .5) ** 2 + (zz - .5) ** 2) * 9)
                    ).astype(np.complex64)
    return traj, maps, x_true


def main(n=None, nc=8, big=False, device=None):
    dev = device_of(device)
    n = n or (128 if big else 64)
    rng = np.random.default_rng(0)
    traj, maps, x_true = make_problem(n, nc, rng)

    t0 = time.time()
    recon = SenseRecon(traj, maps, oversamp=1.25, width=4,
                       iters=40, tol=1e-5, precond="jacobi", device=dev)
    sync(dev)
    t_init = time.time() - t0
    print(f"pipeline built: {t_init:.1f}s "
          f"(device={dev.type}, M={recon.n_samples}, nc={nc}, {n}^3)")

    # a "stream" of acquisitions: same geometry, new k-space every scan
    # (a global phase rotation per scan: the recon rotates identically)
    y0 = recon.simulate(x_true)
    phases = (0.0, 0.3, -1.1)

    t0 = time.time()
    x = recon(y0)
    t_first = time.time() - t0
    err = rel_err(x, x_true)
    print(f"first acquisition: {t_first:.1f}s, iters={recon.last_iters}, "
          f"rel_err vs truth={err:.2e}")

    warm, errs = [], []
    for i, ph in enumerate(phases[1:], start=2):
        y = y0 * np.exp(1j * ph)
        t0 = time.time()
        xd = recon(y, output="device")      # volume STAYS on the device
        sync(dev)
        dt = time.time() - t0
        # copy to the host only when the host needs pixels
        xh = xd.cpu().numpy()
        e = rel_err(xh, x * np.exp(1j * ph))
        warm.append(dt)
        errs.append(e)
        print(f"acquisition {i}: warm solve {dt*1e3:.0f} ms "
              f"(device-resident, {xd.device}), iters={recon.last_iters}, "
              f"rel_err={e:.2e}")
    print("OK")
    return {"device": str(dev), "n": n, "nc": nc,
            "samples": recon.n_samples, "init_s": t_init,
            "first_s": t_first, "warm_s": warm, "iters": recon.last_iters,
            "rel_err_vs_truth": err, "rel_err_rotated": max(errs)}


if __name__ == "__main__":
    main(**cli(__doc__, big=True))
