"""Non-Cartesian NUFFT host geometry: Kaiser-Bessel weights, trajectory sort,
gridding CSR, deapodization, Pipe-Menon density compensation (host numpy,
copied from indigo_tpu/noncart.py).

These functions run once per pipeline on the host, so they stay numpy; the
tests hold each one array-equal to indigo_tpu's so the copies cannot drift.
``pipe_menon_dcf`` can also run its fixed point on a torch device.
``interp_mat`` takes the reference's three branches: the native C++ code
(``native``, a copy of the reference's source), its numpy build, or ``auto``.

Conventions:
  * trajectories are (M, d) arrays in cycles/pixel, range [-0.5, 0.5).
  * the image of shape N is centered at pixel N//2; the forward model equals
    s_i = sum_j x[j] * exp(-2*pi*i * k_i . (j - N//2))  (type-2 NUFFT).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .utils import default_device

__all__ = [
    "kaiser_bessel", "beatty_beta", "interp_mat", "deapodization",
    "checkerboard", "sort_trajectory", "tiled_order", "DEFAULT_TILES",
    "pipe_menon_dcf", "zpad_mat",
]

# Grid tiles of 128 nodes, shaped per rank so a KB patch touches few tiles;
# the tile plan (ops/tile_interp.py) and the trajectory sort share them.
DEFAULT_TILES = {1: (128,), 2: (8, 16), 3: (4, 4, 8)}


def _morton_key(coords):
    """Interleave the bits of integer coordinate arrays (d, n) -> (n,)."""
    coords = np.asarray(coords, dtype=np.uint64)
    d, n = coords.shape
    nbits = max(1, int(np.max(coords)).bit_length()) if coords.size else 1
    key = np.zeros(n, dtype=np.uint64)
    for b in range(nbits):
        for axis in range(d):
            bit = (coords[axis] >> np.uint64(b)) & np.uint64(1)
            key |= bit << np.uint64(b * d + (d - 1 - axis))
    return key


def tiled_order(grid_shape, tile=None):
    """Permutation ordering grid nodes tile-by-tile, tiles in Morton order."""
    grid_shape = tuple(int(g) for g in grid_shape)
    nd = len(grid_shape)
    if tile is None:
        tile = DEFAULT_TILES[nd]
    tile = tuple(int(t) for t in tile)
    for g, t in zip(grid_shape, tile):
        if g % t:
            raise ValueError(f"grid {grid_shape} not divisible by tile {tile}")
    nblocks = tuple(g // t for g, t in zip(grid_shape, tile))
    bidx = np.indices(nblocks).reshape(nd, -1)
    morder = np.argsort(_morton_key(bidx), kind="stable")
    idx = np.arange(int(np.prod(grid_shape))).reshape(grid_shape)
    blk = []
    for g, t in zip(grid_shape, tile):
        blk.extend([g // t, t])
    v = idx.reshape(blk)
    order = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    v = np.ascontiguousarray(v.transpose(order)).reshape(
        int(np.prod(nblocks)), int(np.prod(tile)))
    return v[morder].ravel()


def kaiser_bessel(t, width, beta):
    """Kaiser-Bessel kernel value at offset ``t`` (|t| <= width/2)."""
    t = np.asarray(t, dtype=np.float64)
    x = 1.0 - (2.0 * t / width) ** 2
    x = np.clip(x, 0.0, None)
    return np.i0(beta * np.sqrt(x)) / np.i0(beta)


def beatty_beta(width, oversamp):
    """Optimal KB shape parameter (Beatty, Nishimura & Pauly 2005)."""
    return np.pi * np.sqrt(
        (width / oversamp) ** 2 * (oversamp - 0.5) ** 2 - 0.8)


def sort_trajectory(traj, grid_shape, tile=None):
    """Permutation sorting samples by grid cell (or by the cell's tile, in
    Morton order, when ``tile`` is given) for locality."""
    traj = np.asarray(traj)
    G = np.asarray(grid_shape)
    c = (traj + 0.5) % 1.0 * G  # cell coordinate in [0, G)
    cell = np.floor(c).astype(np.int64)
    if tile is not None:
        blocks = np.stack([cell[:, d] // tile[d]
                           for d in range(traj.shape[1])])
        key = _morton_key(blocks)
    else:
        key = np.zeros(len(traj), dtype=np.int64)
        for d in range(traj.shape[1]):
            key = key * G[d] + cell[:, d]
    return np.argsort(key, kind="stable")


def interp_mat(traj, grid_shape, width=4, beta=None, chunk=1 << 16,
               impl="auto"):
    """Gridding/interpolation CSR matrix (M, prod(grid_shape)).

    Row i holds the KB weights interpolating the *centered* oversampled
    spectrum at grid coordinate traj[i]*G + G/2, with periodic wraparound.
    ``impl``: 'native' (the multithreaded C++ code, ``native``; raises
    ``RuntimeError`` when its library is unavailable), 'numpy' (vectorized,
    chunked), or 'auto' (native when its library loads, else numpy), as in
    the reference. The two builds differ by at most one f32 rounding of a
    weight (the C++ code's polynomial Bessel I0 against ``np.i0``).
    """
    traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
    M, ndim = traj.shape
    G = tuple(int(g) for g in grid_shape)
    assert len(G) == ndim, (G, ndim)
    if beta is None:
        beta = beatty_beta(width, 2.0)
    Ntot = int(np.prod(G))

    if impl in ("auto", "native"):
        from . import native
        out = native.kb_interp_ell(traj, G, width, float(beta)) \
            if native.available() else None
        if out is not None:
            cols, wts = out
            row_nnz = cols.shape[1]
            indptr = np.arange(M + 1, dtype=np.int64) * row_nnz
            A = sp.csr_matrix(
                (wts.ravel(), cols.ravel(), indptr), shape=(M, Ntot))
            A.sum_duplicates()
            return A
        if impl == "native":
            raise RuntimeError("native gridding library unavailable"
                               + (f": {native._error}" if native._error
                                  else ""))
    elif impl != "numpy":
        raise ValueError(f"interp_mat: unknown impl {impl!r}")

    parts = []
    for lo in range(0, M, chunk):
        t = traj[lo:lo + chunk]
        m = len(t)
        cols = np.zeros((m, 1), dtype=np.int64)
        wts = np.ones((m, 1), dtype=np.float64)
        for d in range(ndim):
            c = (t[:, d] + 0.5) * G[d]  # centered grid coordinate
            base = np.ceil(c - width / 2.0).astype(np.int64)
            offs = np.arange(width)
            idx = base[:, None] + offs[None, :]          # (m, width)
            w_d = kaiser_bessel(c[:, None] - idx, width, beta)
            idx = np.mod(idx, G[d])
            cols = cols[:, :, None] * G[d] + idx[:, None, :]
            wts = wts[:, :, None] * w_d[:, None, :]
            cols = cols.reshape(m, -1)
            wts = wts.reshape(m, -1)
        nnz_row = cols.shape[1]
        rows = np.repeat(np.arange(lo, lo + m), nnz_row)
        parts.append(sp.coo_matrix(
            (wts.ravel().astype(np.float32), (rows, cols.ravel())),
            shape=(M, Ntot)))
    A = parts[0] if len(parts) == 1 else sum(parts[1:], parts[0])
    A = A.tocsr()
    A.sum_duplicates()
    return A


def _apod_1d(G, N, width, beta, quad_pts=2001):
    """A(x) = FT of the KB kernel at image offsets; numeric quadrature."""
    t = np.linspace(-width / 2.0, width / 2.0, quad_pts)
    kbv = kaiser_bessel(t, width, beta)
    x = (np.arange(N) - N // 2) / float(G)  # cycles per grid unit
    ph = np.cos(2.0 * np.pi * t[None, :] * x[:, None])
    return np.trapezoid(kbv[None, :] * ph, t, axis=1)


def deapodization(img_shape, grid_shape, width=4, beta=None):
    """Real deapodization array (img_shape): 1 / FT(KB) per axis, outer prod."""
    if beta is None:
        beta = beatty_beta(width, 2.0)
    out = np.ones((), dtype=np.float64)
    for N, G in zip(img_shape, grid_shape):
        a = _apod_1d(G, N, width, beta)
        out = np.multiply.outer(out, 1.0 / a)
    return out.astype(np.float32)


def zpad_mat(img_shape, grid_shape):
    """Sparse 0/1 matrix (prod(grid), prod(img)) embedding the image centered
    in the oversampled grid (the matrix form of ``operators.CropPad``)."""
    img_shape = tuple(img_shape)
    grid_shape = tuple(grid_shape)
    offs = [(g - n) // 2 for n, g in zip(img_shape, grid_shape)]
    idx = np.indices(img_shape).reshape(len(img_shape), -1)
    lin = np.zeros(idx.shape[1], dtype=np.int64)
    for d, g in enumerate(grid_shape):
        lin = lin * g + (idx[d] + offs[d])
    n = int(np.prod(img_shape))
    return sp.csr_matrix(
        (np.ones(n, np.float32), (lin, np.arange(n))),
        shape=(int(np.prod(grid_shape)), n))


def pipe_menon_dcf(traj, grid_shape, width=4, beta=None, iters=30,
                   impl="auto", device=None):
    """Density-compensation weights by Pipe-Menon fixed point.

    w_{k+1} = w_k / |G G^H w_k|: after convergence, gridding with weights w
    approximates a flat density. Returns float32 numpy weights (M,),
    normalised to a maximum of 1.

    ``impl``:
      'host'   — the scipy-CSR fixed point (the executable spec, copied);
        minutes at 3D/1M-sample scale.
      'device' — the same fixed point through the KB gather and its
        ``index_add_`` adjoint (``ops/tile_interp.kb_gather``/``kb_scatter``, one
        column) on ``device``.
      'auto'   — 'device' when ``device`` is a CUDA device and the grid is
        at least 64^3, else 'host' (the reference decides by platform).
    ``device=None`` is the card (an error where there is none), as the
    reference takes its device path whenever an accelerator is up;
    ``device="cpu"`` asks for the host. An explicit ``impl="host"`` needs
    no device.
    """
    traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
    M = len(traj)
    G_ = tuple(int(g) for g in grid_shape)
    if impl != "host":
        device = default_device(device)
    if impl == "auto":
        impl = "device" if (device.type == "cuda"
                            and np.prod(G_) >= 64 ** 3) else "host"

    if impl == "device":
        from .ops.tile_interp import (kb_gather, kb_patches, kb_scatter,
                                      plan_tile_interp)

        corner, wkb = kb_patches(plan_tile_interp(traj, G_, width=width,
                                                  beta=beta))
        corner = torch.from_numpy(corner).to(device)
        wkb = torch.from_numpy(wkb).to(device)
        w = torch.ones((M, 1), dtype=torch.float32, device=device)
        for _ in range(iters):
            g = kb_scatter(corner, wkb, G_, w)
            d = kb_gather(corner, wkb, G_, g)
            w = w / torch.clamp(d.abs(), min=1e-12)
        return (w / w.max())[:, 0].cpu().numpy().astype(np.float32)
    if impl != "host":
        raise ValueError(f"unknown impl {impl!r}")

    G = interp_mat(traj, grid_shape, width=width, beta=beta)
    w = np.ones(M, dtype=np.float64)
    for _ in range(iters):
        d = G @ (G.conj().T @ w)
        d = np.abs(np.asarray(d).ravel())
        w = w / np.maximum(d, 1e-12)
    # normalize so DC gets unit total weight density
    return (w / w.max()).astype(np.float32)


def checkerboard(shape, shifted=False):
    """(-1)^(sum n_d) diagonal for centered FFTs, as a flat float32 array.

    ``shifted=True`` returns D_out, which includes the global sign
    (-1)^(sum G_d/2).
    """
    out = np.ones((), dtype=np.float32)
    sign = 1.0
    for g in shape:
        assert g % 2 == 0, "centered FFT checkerboard requires even dims"
        out = np.multiply.outer(out, (-1.0) ** np.arange(g))
        sign *= (-1.0) ** (g // 2)
    out = out.astype(np.float32)
    if shifted:
        out = out * np.float32(sign)
    return out.ravel()
