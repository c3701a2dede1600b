"""SENSE / NUFFT forward models (torch operator trees).

Counterpart of ``indigo_tpu/models/sense.py``: ``NufftPlan``, ``nufft_op``
and ``sense_nufft_op`` on two branches: tile gridding with the fused
matmul-DFT (``interp="tile"``, ``fft="mm"``, periodic tiling -> one
``GridDFT`` leaf), and sparse gridding (``interp="sparse"``, ``fft="mm"``:
``SpMatrix`` [. ``Perm``] . ``CenteredDFT``). The XLA-FFT chain
(``fft="xla"``) and tile gridding on grids that do not tile periodically
are still to be ported and raise.

Layout conventions (column-batched, like the reference):
  * image vectors are flattened C-order, shape (prod(img_shape), K)
  * multi-coil k-space is coil-major stacked: shape (ncoil*M, K)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..operators import (CenteredDFT, Diag, GridDFT, KronI, Perm, SpMatrix,
                         VStack)
from ..noncart import (DEFAULT_TILES, beatty_beta, deapodization, interp_mat,
                       sort_trajectory, tiled_order)

__all__ = ["nufft_op", "sense_nufft_op", "NufftPlan"]


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
             name="NUFFT"):
    """Type-2 NUFFT operator A: image -> k-space samples. Returns (A, plan).

    A = G [. P] . Fc . Z [. Da], as in the reference:
      * ``interp="tile"`` with ``fft="mm"`` on a periodic tiling: G, Fc and
        Z fuse into one ``GridDFT`` leaf;
      * ``interp="sparse"`` with ``fft="mm"``: G is the KB interpolation
        ``SpMatrix`` (kernel K3/K4 on CUDA) and Fc . Z one ``CenteredDFT``.
        With ``col_tiling`` (default on unless ``interp="tile"``, as in the
        reference), the samples are sorted by Morton tile, the grid columns
        are re-tiled into Morton order (``noncart.tiled_order``), folded
        into the CSR indices, and P is the ``Perm`` leaf that applies that
        order.
    'auto' resolves as the reference does: interp 'tile' for 2D/3D and
    'sparse' for 1D; fft 'mm' when every grid dim is even and <= 512.
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
    if fft != "mm" or interp not in ("tile", "sparse"):
        raise NotImplementedError(
            f"nufft_op(interp={interp!r}, fft={fft!r}) is not ported yet: "
            "only fft='mm' with interp='tile' or 'sparse' (ROADMAP Queue 1, "
            "items 6 and 10)")

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
        A = GridDFT(tplan, img_shape, name="GridDFT")
    else:
        Gcsr = interp_mat(traj_s, grid_shape, width=width, beta=beta)
        if tile is not None:
            cperm = tiled_order(grid_shape, tile)
            inv = np.empty_like(cperm)
            inv[cperm] = np.arange(len(cperm))
            Gcsr = Gcsr.tocsr(copy=True)
            Gcsr.indices = inv[Gcsr.indices].astype(Gcsr.indices.dtype)
            Gcsr.has_sorted_indices = False
            chain.append(Perm(cperm, name="GridTiling"))
        A = SpMatrix(Gcsr, name="Gridding")
        chain.append(CenteredDFT(img_shape, grid_shape, name="PadDFT"))
    da = deapodization(img_shape, grid_shape, width=width, beta=beta)
    if deapod:
        chain.append(Diag(da, name="Deapod"))
    for op in chain:
        A = A * op
    A._name = name
    plan = NufftPlan(img_shape, grid_shape, traj_s, width, float(beta),
                     perm, float(oversamp), deapod=da)
    return A, plan


def sense_nufft_op(traj, maps, oversamp=1.5, width=4, beta=None, sort=True,
                   fft="auto", interp="auto", col_tiling=None):
    """Multi-coil SENSE NUFFT operator: (ncoil*M, prod(img)).

    A = KronI(nc, G Fc Z) . VStack([Diag(Da * map_c)]) — the deapodization
    folded into the per-coil diagonals, as in the reference.
    ``fft``/``interp``/``col_tiling`` pass through to :func:`nufft_op`.
    """
    maps = np.asarray(maps)
    nc = maps.shape[0]
    img_shape = maps.shape[1:]
    core, plan = nufft_op(traj, img_shape, oversamp=oversamp, width=width,
                          beta=beta, sort=sort, deapod=False, fft=fft,
                          interp=interp, col_tiling=col_tiling)
    coils = VStack(
        [Diag((plan.deapod * maps[c]).ravel().astype(np.complex64),
              name=f"Map{c}") for c in range(nc)], name="Coils")
    A = KronI(nc, core, name="PerCoil") * coils
    return A, plan
