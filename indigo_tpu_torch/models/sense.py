"""SENSE / NUFFT forward models (torch operator trees).

Counterpart of ``indigo_tpu/models/sense.py``: ``centered_fft_op``,
``NufftPlan``, ``nufft_op``, ``sense_nufft_op`` and ``cartesian_sense_op``.
Each function returns its tree on ``device`` (default ``"cuda"``, as
``SenseRecon``): the geometry is planned on the host, each leaf builds its
arrays on ``device``, and the solvers run where the tree lives.
``device="cpu"`` keeps everything on the host. Host data is narrowed to
32-bit as every leaf narrows it (``utils.as_tensor``).

Layout conventions (column-batched, like the reference):
  * image vectors are flattened C-order, shape (prod(img_shape), K)
  * multi-coil k-space is coil-major stacked: shape (ncoil*M, K)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..operators import (CenteredDFT, CropPad, Diag, GridDFT, KBInterp,
                         KronI, Mask, Perm, SpMatrix, UnscaledFFT, VStack)
from ..noncart import (DEFAULT_TILES, beatty_beta, checkerboard,
                       deapodization, interp_mat, sort_trajectory,
                       tiled_order)

__all__ = ["centered_fft_op", "nufft_op", "sense_nufft_op",
           "cartesian_sense_op", "NufftPlan"]


def centered_fft_op(shape, dtype=np.complex64, device="cuda"):
    """Centered FFT  fftshift . fft . ifftshift  as D_out * F * D_in.

    The shift diagonals are exact (+-1) float32 checkerboards for even
    dims.
    """
    din = Diag(checkerboard(shape), name="fftshift_in", device=device)
    dout = Diag(checkerboard(shape, shifted=True), name="fftshift_out",
                device=device)
    return dout * UnscaledFFT(shape, dtype=dtype, device=device) * din


def gridding_core(tplan, img_shape, device):
    """G Fc Z for a tile plan with the matmul DFT: one ``GridDFT`` leaf on
    a periodic no-halo tiling, else ``KBInterp * CenteredDFT``."""
    grid = tuple(int(g) for g in tplan.grid_shape)
    if tuple(tplan.ext) == grid:
        return GridDFT(tplan, img_shape, name="GridDFT", device=device)
    return (KBInterp(tplan, name="Gridding", device=device)
            * CenteredDFT(img_shape, grid, name="PadDFT", device=device))


@dataclass
class NufftPlan:
    """Host-side plan for a NUFFT operator (geometry + permutation).

    ``perm`` maps user sample order -> internal order; per-sample data is
    permuted as y_internal = y_user[perm].
    """
    img_shape: tuple
    grid_shape: tuple
    traj: np.ndarray
    width: int
    beta: float
    perm: np.ndarray
    oversamp: float
    deapod: np.ndarray = None  # real deapodization array (img_shape)

    @property
    def n_samples(self):
        return len(self.perm)

    def _index(self, order, ncoil):
        M = self.n_samples
        return (np.arange(ncoil)[:, None] * M + order[None, :]).ravel()

    def sort_samples(self, a, axis=0, ncoil=1):
        """User order -> internal order (each (M,) coil block permuted)."""
        return np.take(np.asarray(a), self._index(self.perm, ncoil),
                       axis=axis)

    def unsort_samples(self, a, axis=0, ncoil=1):
        """Internal order -> user order (inverse of sort_samples)."""
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(len(self.perm))
        return np.take(np.asarray(a), self._index(inv, ncoil), axis=axis)


def nufft_op(traj, img_shape, oversamp=1.5, width=4, beta=None, sort=True,
             col_tiling=None, deapod=True, interp="auto", fft="auto",
             name="NUFFT", device="cuda"):
    """Type-2 NUFFT operator A: image -> k-space samples. Returns (A, plan)
    with A on ``device``.

    A = G [. P] . Fc . Z [. Da], as in the reference. ``interp`` selects G:
      * 'tile': the KB gather/scatter on the natural-order grid
        (``KBInterp``);
      * 'sparse': the KB interpolation ``SpMatrix`` (kernel K3/K4 on
        CUDA). With ``col_tiling`` (default on unless ``interp="tile"``),
        the samples are sorted by Morton tile, the grid columns are
        re-tiled into Morton order (``noncart.tiled_order``), folded into
        the CSR indices, and P is the ``Perm`` leaf that applies that order;
      * 'auto': 'tile' for 2D/3D, 'sparse' for 1D.
    ``fft`` selects Fc . Z:
      * 'mm': one ``CenteredDFT`` leaf (per-axis matrix products); with
        ``interp="tile"`` on a periodic no-halo tiling G, Fc and Z fuse
        into one ``GridDFT`` leaf;
      * 'xla': the explicit chain ``centered_fft_op(grid) * CropPad`` over
        the library FFT (the reference's name, kept for call
        compatibility; here it means ``torch.fft``);
      * 'auto': 'mm' when every grid dim is even and <= 512, else 'xla'.
    """
    traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
    img_shape = tuple(int(n) for n in img_shape)
    grid_shape = tuple(int(2 * round(n * oversamp / 2)) for n in img_shape)
    if beta is None:
        beta = beatty_beta(width, oversamp)

    if col_tiling is None:
        col_tiling = interp != "tile"
    tile = DEFAULT_TILES.get(len(img_shape)) if col_tiling else None
    if tile is not None and any(g % t for g, t in zip(grid_shape, tile)):
        tile = None  # grid not tileable; row-major columns
    if interp == "auto":
        interp = "tile" if len(img_shape) >= 2 else "sparse"
    if fft == "auto":
        fft = ("mm" if all(g % 2 == 0 and g <= 512 for g in grid_shape)
               else "xla")
    if fft not in ("mm", "xla") or interp not in ("tile", "sparse"):
        raise ValueError(f"nufft_op: unknown interp={interp!r} or "
                         f"fft={fft!r}")

    perm = (sort_trajectory(traj, grid_shape, tile=tile) if sort
            else np.arange(len(traj)))
    traj_s = traj[perm]

    chain = []
    if interp == "tile":
        from ..ops.tile_interp import plan_tile_interp
        tplan = plan_tile_interp(traj_s, grid_shape, width=width, beta=beta,
                                 reorder=True)
        if tplan.sample_perm is not None:
            perm = perm[tplan.sample_perm]
            traj_s = traj_s[tplan.sample_perm]
        G = (None if fft == "mm"
             else KBInterp(tplan, name="Gridding", device=device))
    else:
        Gcsr = interp_mat(traj_s, grid_shape, width=width, beta=beta)
        if tile is not None:
            cperm = tiled_order(grid_shape, tile)
            inv = np.empty_like(cperm)
            inv[cperm] = np.arange(len(cperm))
            Gcsr = Gcsr.tocsr(copy=True)
            Gcsr.indices = inv[Gcsr.indices].astype(Gcsr.indices.dtype)
            Gcsr.has_sorted_indices = False
            chain.append(Perm(cperm, name="GridTiling", device=device))
        G = SpMatrix(Gcsr, name="Gridding", device=device)
    if G is None:
        A, factors = gridding_core(tplan, img_shape, device), []
    elif fft == "mm":
        A = G
        factors = chain + [CenteredDFT(img_shape, grid_shape, name="PadDFT",
                                       device=device)]
    else:
        A = G
        factors = chain + [centered_fft_op(grid_shape, device=device),
                           CropPad(img_shape, grid_shape, name="Zpad",
                                   device=device)]
    da = deapodization(img_shape, grid_shape, width=width, beta=beta)
    if deapod:
        factors.append(Diag(da, name="Deapod", device=device))
    for op in factors:
        A = A * op
    A._name = name
    plan = NufftPlan(img_shape, grid_shape, traj_s, width, float(beta),
                     perm, float(oversamp), deapod=da)
    return A, plan


def sense_nufft_op(traj, maps, oversamp=1.5, width=4, beta=None, sort=True,
                   fft="auto", interp="auto", col_tiling=None,
                   device="cuda"):
    """Multi-coil SENSE NUFFT operator: (ncoil*M, prod(img)), on ``device``.

    A = KronI(nc, G Fc Z) . VStack([Diag(Da * map_c)]) — the deapodization
    folded into the per-coil diagonals, as in the reference.
    ``fft``/``interp``/``col_tiling`` pass through to :func:`nufft_op`.
    """
    maps = np.asarray(maps)
    nc = maps.shape[0]
    img_shape = maps.shape[1:]
    core, plan = nufft_op(traj, img_shape, oversamp=oversamp, width=width,
                          beta=beta, sort=sort, deapod=False, fft=fft,
                          interp=interp, col_tiling=col_tiling,
                          device=device)
    coils = VStack(
        [Diag((plan.deapod * maps[c]).ravel().astype(np.complex64),
              name=f"Map{c}", device=device) for c in range(nc)],
        name="Coils")
    return KronI(nc, core, name="PerCoil") * coils, plan


def cartesian_sense_op(mask, maps, device="cuda"):
    """Cartesian multi-coil SENSE: A = KronI(nc, P Fc) . VStack(Diag maps),
    on ``device``.

    mask: boolean array over the image grid (sampled k-space locations, in
    centered/fftshifted order); maps: (ncoil, *img_shape). P is the
    ``Mask`` row-selection leaf (one gather per direction).
    """
    maps = np.asarray(maps)
    nc = maps.shape[0]
    img_shape = maps.shape[1:]
    core = (Mask.from_bool(mask, name="Sampling", device=device)
            * centered_fft_op(img_shape, device=device))
    coils = VStack(
        [Diag(maps[c].ravel().astype(np.complex64), name=f"Map{c}",
              device=device) for c in range(nc)], name="Coils")
    return KronI(nc, core, name="PerCoil") * coils
