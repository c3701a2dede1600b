"""Toeplitz-embedded NUFFT normal operator: its spectrum.

Counterpart of ``indigo_tpu/toeplitz.py`` (``toeplitz_kernel``):

    A^H A x  ~=  crop( IFFT( T * FFT( pad_2x(x) ) ) )

T is the real spectrum of the point-spread kernel on the doubled grid,
computed once as the gridded adjoint NUFFT of the weights on a 2N image.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["toeplitz_kernel"]


def toeplitz_kernel(traj, img_shape, oversamp=1.5, width=5, weights=None,
                    psd_clip=False, return_info=False, warn=True,
                    impl="auto", device=None):
    """Real spectrum T (2N grid, float32 numpy) of the normal-operator kernel.

    Same contract as the reference: ``psd_clip`` clips negative spectrum
    values, ``return_info`` adds ``min``/``max``/``clipped`` diagnostics,
    ``warn`` prints a hint for meaningfully indefinite kernels.

    ``impl``: 'host' is the numpy/scipy build; 'device' runs the adjoint
    gridding (torch ``index_add_``) and the FFTs (``torch.fft``) on
    ``device``; 'auto' picks 'device' when ``device`` is a CUDA device and
    the doubled oversampled grid is large (>= 64^3), else 'host'.
    """
    from .noncart import beatty_beta

    img_shape = tuple(int(s) for s in img_shape)
    big = tuple(2 * s for s in img_shape)
    grid2 = tuple(int(2 * round(s * oversamp / 2)) for s in big)
    beta = beatty_beta(width, oversamp)
    M = len(np.atleast_2d(traj))
    w = np.ones(M, np.complex64) if weights is None else \
        np.asarray(weights, np.complex64).ravel()
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    if impl == "auto":
        impl = "device" if (device.type == "cuda"
                            and np.prod(grid2) >= 64 ** 3) else "host"
    if impl == "device":
        Tf = _toeplitz_kernel_device(traj, big, grid2, width, beta, w,
                                     device)
    elif impl == "host":
        Tf = _toeplitz_kernel_host(traj, big, grid2, width, beta, w)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    tmin = float(Tf.min())
    tmax = float(np.abs(Tf).max())
    clipped = False
    if psd_clip:
        Tf = np.maximum(Tf, 0.0)
        clipped = tmin < 0
    elif warn and tmin < -1e-3 * tmax:
        import sys
        print(f"[indigo_tpu_torch.toeplitz] kernel spectrum has negative "
              f"values (min {tmin:.3e}); CG on K + lamda*I is stable for "
              f"lamda > {-tmin:.3e} (SenseRecon applies this floor), or "
              f"pass psd_clip=True", file=sys.stderr)
    Tf = np.ascontiguousarray(Tf)
    if return_info:
        return Tf, {"min": tmin, "max": tmax, "clipped": clipped}
    return Tf


def _toeplitz_kernel_host(traj, big, grid2, width, beta, w):
    """numpy/scipy kernel build (the executable spec)."""
    from .noncart import interp_mat, deapodization

    import scipy.fft as sfft  # keeps complex64 (numpy.fft upcasts)

    G = interp_mat(traj, grid2, width=width, beta=beta)
    v = np.asarray(G.conj().T @ w).reshape(grid2).astype(np.complex64)
    # Fc^H = fftshift . (prod(grid2) * ifftn) . ifftshift
    u = np.fft.fftshift(
        sfft.ifftn(np.fft.ifftshift(v), workers=-1)) * np.float32(
            np.prod(grid2))
    offs = [(g - b) // 2 for b, g in zip(big, grid2)]
    sl = tuple(slice(o, o + b) for b, o in zip(big, offs))
    t = (u[sl] * deapodization(big, grid2, width=width, beta=beta)
         ).astype(np.complex64)
    return sfft.fftn(np.fft.ifftshift(t), workers=-1).real.astype(np.float32)


def _toeplitz_kernel_device(traj, big, grid2, width, beta, w, device):
    """Same math as the host build: torch adjoint gridding + torch.fft.

    At 256^3 the doubled oversampled grid is 640^3 (2.1 GB complex64); the
    host build takes minutes there.
    """
    from .noncart import deapodization
    from .ops.tile_interp import plan_tile_interp, kb_patches, \
        tile_interp_apply

    plan = plan_tile_interp(traj, grid2, width=width, beta=beta)
    corner, wkb = kb_patches(plan)
    corner = torch.from_numpy(corner).to(device)
    wkb = torch.from_numpy(wkb).to(device)
    y = torch.from_numpy(w[:, None]).to(device)
    v = tile_interp_apply(corner, wkb, grid2, y, adjoint=True)[0]
    del corner, wkb, y
    dims = tuple(range(len(grid2)))
    v = torch.fft.ifftshift(v, dim=dims)
    u = torch.fft.fftshift(torch.fft.ifftn(v, dim=dims), dim=dims)
    del v
    u = u * np.float32(np.prod(grid2))
    offs = [(g - b) // 2 for b, g in zip(big, grid2)]
    sl = tuple(slice(o, o + b) for b, o in zip(big, offs))
    da = torch.from_numpy(deapodization(big, grid2, width=width,
                                        beta=beta)).to(device)
    t = u[sl] * da
    del u
    t = torch.fft.ifftshift(t, dim=dims)
    Tf = torch.fft.fftn(t, dim=dims).real.to(torch.float32)
    return np.ascontiguousarray(Tf.cpu().numpy())
