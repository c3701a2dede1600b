"""Frozen numpy oracle — the executable float64 spec for every config.

The port's own copy of ``indigo_tpu/oracle/__init__.py`` (numpy only):
brute-force, obviously-correct implementations that the torch code is
tested against, so the spec is at hand where the reference package is not
installed. ``tests/test_torch_cartesian.py`` holds the two copies equal.
Keep it dependency-free and do not optimize it.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "nufft_forward", "nufft_adjoint", "sense_nufft_forward", "cg",
    "fista", "soft_thresh", "centered_fft",
    "cartesian_sense_forward", "cartesian_sense_adjoint", "dwt",
]


def _phases(traj, img_shape):
    traj = np.atleast_2d(traj)
    idx = np.indices(img_shape).reshape(len(img_shape), -1)
    centered = np.stack(
        [idx[d] - img_shape[d] // 2 for d in range(len(img_shape))])
    return np.exp(-2j * np.pi * (traj @ centered))  # (M, prod(img))


def nufft_forward(x, traj, img_shape):
    """Direct type-2 NUFFT: s_i = sum_j x[j] e^{-2 pi i k_i.(j - N//2)}."""
    E = _phases(traj, img_shape)
    return E @ x.reshape(int(np.prod(img_shape)), -1)


def nufft_adjoint(s, traj, img_shape):
    E = _phases(traj, img_shape)
    return E.conj().T @ s.reshape(len(np.atleast_2d(traj)), -1)


def sense_nufft_forward(x, traj, maps):
    """Multi-coil: stack per-coil direct NUFFTs of maps[c] * x (coil-major)."""
    maps = np.asarray(maps)
    img_shape = maps.shape[1:]
    xs = x.reshape(int(np.prod(img_shape)), -1)
    outs = [nufft_forward(maps[c].reshape(-1, 1) * xs, traj, img_shape)
            for c in range(maps.shape[0])]
    return np.concatenate(outs, axis=0)


def centered_fft(x, axes=None):
    """fftshift(fftn(ifftshift(x))) over the given axes."""
    axes = tuple(range(x.ndim)) if axes is None else axes
    return np.fft.fftshift(
        np.fft.fftn(np.fft.ifftshift(x, axes=axes), axes=axes, norm=None),
        axes=axes)


def cartesian_sense_forward(x, mask, maps):
    """A x for Cartesian SENSE: per coil, centered FFT of maps[c]*x, keep
    the masked k-space rows; coil-major stacked (float64 direct)."""
    maps = np.asarray(maps, np.complex128)
    img_shape = maps.shape[1:]
    keep = np.flatnonzero(np.asarray(mask).ravel())
    xs = np.asarray(x, np.complex128).reshape(int(np.prod(img_shape)), -1)
    outs = []
    for c in range(maps.shape[0]):
        v = (maps[c].reshape(-1, 1) * xs).reshape(img_shape + (-1,))
        f = centered_fft(v, axes=tuple(range(len(img_shape))))
        outs.append(f.reshape(-1, xs.shape[1])[keep])
    return np.concatenate(outs, axis=0)


def cartesian_sense_adjoint(y, mask, maps):
    """A^H y: zero-fill each coil's samples, inverse centered unnormalized
    FFT (N * icentered), weight by conj(maps[c]), sum coils."""
    maps = np.asarray(maps, np.complex128)
    img_shape = maps.shape[1:]
    n = int(np.prod(img_shape))
    keep = np.flatnonzero(np.asarray(mask).ravel())
    m = len(keep)
    y = np.asarray(y, np.complex128).reshape(maps.shape[0], m, -1)
    axes = tuple(range(len(img_shape)))
    out = 0
    for c in range(maps.shape[0]):
        full = np.zeros((n, y.shape[2]), np.complex128)
        full[keep] = y[c]
        v = full.reshape(img_shape + (-1,))
        u = np.fft.fftshift(
            np.fft.ifftn(np.fft.ifftshift(v, axes=axes), axes=axes),
            axes=axes) * n
        out = out + maps[c].conj().reshape(-1, 1) * u.reshape(n, -1)
    return out


# Orthonormal Daubechies analysis low-pass filters — the oracle carries its
# own copy (the executable spec must not import the implementation it
# checks); tests cross-check wavelet.py against this module, so divergence
# cannot pass unnoticed.
_WAVELETS = {
    "haar": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([0.48296291314469025, 0.836516303737469,
                     0.22414386804185735, -0.12940952255092145]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def _dwt_matrix(L, h):
    """One-level periodic orthogonal analysis matrix (L, L) in float64,
    rows = [approx (L/2) ; detail (L/2)]."""
    T = len(h)
    g = np.array([(-1) ** t * h[T - 1 - t] for t in range(T)])
    W = np.zeros((L, L), dtype=np.float64)
    for k in range(L // 2):
        for t in range(T):
            W[k, (2 * k + t) % L] += h[t]
            W[L // 2 + k, (2 * k + t) % L] += g[t]
    return W


def dwt(x, vol_shape, wavelet="db4", levels=1, adjoint=False):
    """Multi-level orthogonal DWT over a volume (columns = batch), float64.

    In-place coefficient layout: after each level the leading half of each
    transformed axis holds the approximation; the adjoint is the exact
    inverse (orthonormal filters).
    """
    vol_shape = tuple(int(s) for s in vol_shape)
    h = _WAVELETS[wavelet]
    nd = len(vol_shape)
    v = np.array(x, np.complex128).reshape(vol_shape + (-1,))
    lvs = range(levels)
    for lv in (reversed(lvs) if adjoint else lvs):
        sl = tuple(slice(0, s >> lv) for s in vol_shape) + (slice(None),)
        sub = v[sl]
        axes = range(nd)
        for ax in (reversed(axes) if adjoint else axes):
            W = _dwt_matrix(vol_shape[ax] >> lv, h)
            Wd = W.T if adjoint else W
            sub = np.moveaxis(
                np.tensordot(Wd, np.moveaxis(sub, ax, 0), axes=(1, 0)),
                0, ax)
        v[sl] = sub
    return v.reshape(int(np.prod(vol_shape)), -1)


def cg(matvec, b, x0=None, lamda=0.0, tol=1e-6, maxiter=100):
    """Textbook CG on the host in float64 precision."""
    b = np.asarray(b)
    x = np.zeros_like(b) if x0 is None else np.array(x0)
    mv = (lambda v: matvec(v) + lamda * v) if lamda else matvec
    r = b - mv(x)
    p = r.copy()
    rs = np.vdot(r, r).real
    bn = np.linalg.norm(b.ravel()) or 1.0
    for k in range(maxiter):
        if np.sqrt(rs) <= tol * bn:
            break
        Ap = mv(p)
        alpha = rs / np.vdot(p, Ap).real
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = np.vdot(r, r).real
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, {"iters": k, "resid": np.sqrt(rs) / bn}


def soft_thresh(x, lam):
    mag = np.abs(x)
    return np.where(mag > 0, np.maximum(mag - lam, 0) / np.maximum(mag, 1e-30), 0) * x


def fista(gradf, proxg, alpha, x0, maxiter=100):
    x = np.array(x0)
    z = x.copy()
    t = 1.0
    for _ in range(maxiter):
        xn = proxg(z - alpha * gradf(z), alpha)
        tn = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        z = xn + ((t - 1) / tn) * (xn - x)
        x, t = xn, tn
    return x
