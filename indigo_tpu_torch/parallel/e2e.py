"""Multi-device END-TO-END SENSE reconstruction: k-space in, image out.

Counterpart of ``indigo_tpu/parallel/e2e.py``: the serving pipeline
(``models.recon.SenseRecon``) and the sharded Toeplitz CG solvers
(``parallel.recon``) meet here. Every rank of the mesh builds the same
object from the same arrays and calls it with the same k-space; each works
on its own part and gets the whole image back.

3D volumes: the samples are partitioned across the mesh axis, each rank
grids its partition onto the whole oversampled grid (``kb_scatter``), the
grid is ``psum_scatter``'d into z slabs, and the centered inverse DFT and
the deapodised coil combine run slab-distributed (two ``all_to_all``
transposes, as in ``parallel.dist_fft``). The result feeds the
volume-sharded Toeplitz CG without the volume ever being gathered onto one
rank before the result.

2D batches: a stack of S acquisitions (same trajectory and maps per slice)
is data-parallel over the mesh axis: each rank builds the gridded rhs for
its slices with the replicated plan and runs the batched Toeplitz CG
locally (``sense_batch_recon`` semantics; no collective in the solve).

Numerics match the single-device pipeline: the same KB plan weights, the
same fused pad+shift DFT matrices (``ops.dft_fft.centered_pad_dft_mat``),
the same Toeplitz CG.

Grid constraints are met by AUTO-PADDING, as in the reference: the
oversampled grid is rounded up per axis to its tile multiple and (3D) grid_z
further up so that the z tile count divides the mesh axis: a slightly
larger effective oversampling on the padded axes. What cannot be padded
away is raised: the slab CG needs the IMAGE dims Nz and Ny divisible by the
mesh axis size.

The port grids onto the natural-order grid. The reference's tile-binned
adjoint, its merged bin layouts and its tiled-slab switch exist for the
TPU's tiled layout and have no counterpart here; the tile sizes still
decide the sample sort and the grid padding, so both packages agree on the
geometry.
"""
from __future__ import annotations

import numpy as np
import torch

from ..noncart import (DEFAULT_TILES, beatty_beta, deapodization,
                       pipe_menon_dcf, sort_trajectory)
from ..ops.dft_fft import centered_pad_dft_mat, full_f32_matmul
from ..ops.tile_interp import kb_patches, kb_scatter, plan_tile_interp
from ..toeplitz import toeplitz_kernel
from .collectives import all_to_all, psum_scatter
from .mesh import Placement
from .recon import (_block_layout, batched_cg, sense_normal_batched,
                    sense_normal_volsharded)

__all__ = ["SenseReconSharded", "sense_recon_sharded"]


def _dcf_weights(dcf, traj, img_shape, grid, width, beta, device):
    """Resolve the dcf argument to (M,) float32 weights: the same policy as
    ``models.recon.SenseRecon``, with 'pipe_menon' on the padded grid."""
    d = traj.shape[1]
    if dcf is None:
        return np.ones(len(traj), np.float32)
    if isinstance(dcf, str) and dcf == "radial":
        w = (np.sum(traj ** 2, axis=1) ** ((d - 1) / 2.0)
             + (0.5 / max(img_shape)) ** (d - 1)).astype(np.float32)
        return w / w.max()
    if isinstance(dcf, str) and dcf == "pipe_menon":
        return pipe_menon_dcf(traj, grid, width=width, beta=beta,
                              device=device)
    return np.asarray(dcf, np.float32).ravel()


class SenseReconSharded:
    """Multi-device SENSE reconstruction pipeline (k-space in, image out).

    The sharded sibling of :class:`~indigo_tpu_torch.models.recon.SenseRecon`:
    same geometry conventions (traj in cycles/pixel, maps (nc, *img), dcf
    None|'radial'|'pipe_menon'|(M,) weights, Tikhonov ``lamda`` with the
    same gridding-error floor), but the work runs over the
    ``mesh.shape[axis_name]`` ranks of ``mesh``, on ``mesh.device``. Every
    rank builds it from the same arrays and calls it with the same k-space.

    * 3D (maps (nc, Nz, Ny, Nx)): every stage, the rhs build from k-space
      AND the Toeplitz CG, is sharded; samples are partitioned for the
      adjoint gridding, the volume lives in z slabs. ``__call__(y)`` takes
      one acquisition, y (nc, M) (or flat), returns (Nz, Ny, Nx).
    * 2D (maps (nc, Ny, Nx)): data-parallel over a BATCH of acquisitions.
      ``__call__(y)`` takes y (S, nc, M) (or (nc, M) for S=1) and returns
      (S, Ny, Nx); slices are padded to the mesh size and solved
      independently per rank.

    Sample partitioning (3D): the trajectory is tile-sorted once (as on one
    device) and split into p contiguous equal chunks (spatially coherent),
    padded with zero-weight repeats of the last sample; a rank plans and
    keeps the KB patches of its own chunk only.
    """

    def __init__(self, traj, maps, mesh, axis_name="vol", oversamp=1.25,
                 width=4, lamda=None, iters=30, dcf="radial"):
        traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
        maps = np.asarray(maps, dtype=np.complex64)
        mesh.require_member()
        self.nc = int(maps.shape[0])
        self.img_shape = tuple(int(s) for s in maps.shape[1:])
        self.iters = int(iters)
        self.mesh, self.axis_name = mesh, axis_name
        self.device = mesh.device
        p = int(mesh.shape[axis_name])
        self._p = p
        d = traj.shape[1]
        if d not in (2, 3) or len(self.img_shape) != d:
            raise ValueError(
                f"traj is {d}-dim but maps imply {len(self.img_shape)}-dim "
                "(supported: 2D slice batches and 3D volumes)")
        self.ndim = d
        tile = DEFAULT_TILES[d]
        # auto-pad the oversampled grid to the tile multiples the sample
        # sort uses (see module docstring)
        grid = [int(2 * round(s * oversamp / 2)) for s in self.img_shape]
        grid = [-(-g // t) * t for g, t in zip(grid, tile)]
        if d == 3:
            grid[0] = -(-grid[0] // (tile[0] * p)) * (tile[0] * p)
        grid = tuple(grid)
        nt = tuple(g // t for g, t in zip(grid, tile))
        self.grid_shape, self.tile, self.nt = grid, tile, nt
        beta = beatty_beta(width, oversamp)

        w = _dcf_weights(dcf, traj, self.img_shape, grid, width, beta,
                         self.device)

        if d == 3:
            Nz, Ny, Nx = self.img_shape
            if Nz % p or Ny % p:
                raise ValueError(
                    f"mesh axis size {p} must divide the image dims "
                    f"Nz={Nz} and Ny={Ny} (z-slab CG all_to_all splits); "
                    "grid divisibility is auto-padded, image dims cannot "
                    "be")
            self._init_3d(traj, w, width, beta)
        else:
            self._init_2d(traj, w, width, beta)

        # Toeplitz kernel + lamda floor (same policy as SenseRecon; the
        # kernel lives on its own doubled grid, independent of the padded
        # rhs grid)
        Tf, info = toeplitz_kernel(traj, self.img_shape, oversamp=oversamp,
                                   width=width, weights=w, return_info=True,
                                   warn=False, device=self.device)
        self.kernel_info = info
        eps = 10.0 ** (1 - width) * (3.0 if oversamp < 1.25 else 1.0)
        self.lamda_floor = eps * info["max"]
        if lamda is None:
            self.lamda = max(1e-3 * info["max"], self.lamda_floor)
        else:
            self.lamda = float(lamda)
        Tf = np.asarray(Tf, np.float32)

        # adjoint of the fused centered pad+DFT: exact conjugate
        # transposes of the single-device CenteredDFT factors
        Bmats = [np.conj(centered_pad_dft_mat(n, g)).T.copy()
                 for n, g in zip(self.img_shape, grid)]
        self._Bmats = tuple(torch.from_numpy(B).to(self.device)
                            for B in Bmats)
        da = deapodization(self.img_shape, grid, width=width, beta=beta)
        dam = (da[None] * maps).astype(np.complex64)
        if d == 3:
            # this rank's blocks: dam and maps in z slabs, Tf in y slabs of
            # the doubled grid
            slab = Placement(mesh, (None, axis_name))
            self._dam = slab.local(dam)
            self._maps = slab.local(maps)
            self._Tf = slab.local(Tf)
        else:
            self._dam = torch.from_numpy(dam).to(self.device)
            self._maps = torch.from_numpy(maps).to(self.device)
            self._Tf = _block_layout(
                torch.from_numpy(Tf).to(self.device)).contiguous()

    def _patches(self, traj, width, beta):
        plan = plan_tile_interp(traj, self.grid_shape, width=width,
                                beta=beta)
        if plan.ext != self.grid_shape or any(plan.pad_lo):
            raise AssertionError(
                f"padded grid {self.grid_shape} is not tile-periodic")
        self._corner, self._wkb = (torch.from_numpy(a).to(self.device)
                                   for a in kb_patches(plan))

    # ---------------------------------------------------------- 3D

    def _init_3d(self, traj, w, width, beta):
        p = self._p
        # tile-sort globally, partition into contiguous equal chunks (pad =
        # repeat of the last sample with ZERO dcf weight, so padded rows
        # contribute nothing to the rhs)
        perm = sort_trajectory(traj, self.grid_shape, tile=self.tile)
        M = len(traj)
        Mc = -(-M // p)
        pad_ix = np.concatenate(
            [perm, np.full(p * Mc - M, perm[-1], dtype=perm.dtype)])
        self.perm, self.n_samples, self._Mc = perm, M, Mc
        self._chunks = pad_ix.reshape(p, Mc)
        self._w_chunks = np.concatenate(
            [w[perm], np.zeros(p * Mc - M, np.float32)]).reshape(p, Mc)
        r = self.mesh.coords[self.axis_name]
        self._patches(traj[self._chunks[r]], width, beta)

    def _solve_3d(self, y):
        mesh, ax, nc = self.mesh, self.axis_name, self.nc
        r = mesh.coords[ax]
        # sort+chunk+weight: this rank's (Mc, nc), padded rows weigh zero
        wy = (self._w_chunks[r][None] * y[:, self._chunks[r]]).T
        wy = torch.from_numpy(np.ascontiguousarray(wy, np.complex64)).to(
            self.device)
        if wy.is_cuda:
            full_f32_matmul()
        Bz, By, Bx = self._Bmats
        g = kb_scatter(self._corner, self._wkb, self.grid_shape, wy)
        g = psum_scatter(g, mesh, ax, scatter_dimension=1)  # (nc,Gz/p,Gy,Gx)
        # crop + centered inverse DFT, slab-distributed: local y/x
        # contractions, z made local by one all_to_all round trip
        u = torch.einsum("czyx,Yy->czYx", g, By)
        u = torch.einsum("czyx,Xx->czyX", u, Bx)
        u = all_to_all(u, mesh, ax, split_axis=2, concat_axis=1)
        u = torch.einsum("czyx,Zz->cZyx", u, Bz)            # (nc,Nz,Ny/p,Nx)
        u = all_to_all(u, mesh, ax, split_axis=1, concat_axis=2)
        rhs_l = torch.sum(self._dam.conj() * u, dim=0)      # (Nz/p, Ny, Nx)

        def mv(v):
            return sense_normal_volsharded(
                self._Tf, self._maps, v.reshape(rhs_l.shape), ax,
                mesh=mesh).reshape(1, -1)

        xs, resids = batched_cg(mv, rhs_l.reshape(1, -1), lamda=self.lamda,
                                iters=self.iters, psum_axis=ax, mesh=mesh)
        x = Placement(mesh, (ax,)).gather(xs.reshape(rhs_l.shape))
        return x, resids[:, 0]

    # ---------------------------------------------------------- 2D

    def _init_2d(self, traj, w, width, beta):
        # one replicated plan (tile-sorted); y rows follow the same perm at
        # call time
        perm = sort_trajectory(traj, self.grid_shape, tile=self.tile)
        self.perm, self.n_samples = perm, len(traj)
        self._w_sorted = w[perm].astype(np.float32)
        self._patches(traj[perm], width, beta)

    def _solve_2d(self, wy):
        """wy (Sp, M, nc) weighted sorted samples, Sp a multiple of p: this
        rank grids and solves its Sp/p slices."""
        mesh, ax = self.mesh, self.axis_name
        wy_l = Placement(mesh, (ax,)).local(wy, torch.complex64)
        if wy_l.is_cuda:
            full_f32_matmul()
        By, Bx = self._Bmats
        rhs_l = []
        for one in wy_l:
            g = kb_scatter(self._corner, self._wkb, self.grid_shape, one)
            u = torch.einsum("cyx,Yy->cYx", g, By)
            u = torch.einsum("cyx,Xx->cyX", u, Bx)
            rhs_l.append(torch.sum(self._dam.conj() * u, dim=0).reshape(-1))
        xs, resids = batched_cg(
            lambda v: sense_normal_batched(self._Tf, self._maps, v,
                                           layout="block"),
            torch.stack(rhs_l), lamda=self.lamda, iters=self.iters)
        x = Placement(mesh, (ax,)).gather(
            xs.reshape((-1,) + self.img_shape))
        return x, Placement(mesh, (None, ax)).gather(resids)

    # ---------------------------------------------------------- call

    def __call__(self, y, return_resids=False):
        """Reconstruct from k-space.

        3D: y one acquisition, coil-major (nc*M,) or (nc, M) -> (Nz,Ny,Nx).
        2D: y a batch (S, nc, M) (or (nc, M) for S=1) -> (S, Ny, Nx).
        Returns host complex64 numpy (and the residual history with
        ``return_resids=True``), the same on every rank."""
        y = y.detach().cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        if self.ndim == 3:
            if y.size != self.nc * self.n_samples:
                raise ValueError(
                    f"expected {self.nc}x{self.n_samples} samples, got "
                    f"{y.shape}")
            x, resids = self._solve_3d(y.reshape(self.nc, -1))
            S = None
        else:
            if y.ndim == 2 and y.shape == (self.nc, self.n_samples):
                y = y[None]
            if y.ndim != 3 or y.shape[1:] != (self.nc, self.n_samples):
                raise ValueError(
                    f"expected (S, {self.nc}, {self.n_samples}) 2D batch, "
                    f"got {y.shape}")
            S = y.shape[0]
            Sp = -(-S // self._p) * self._p
            wy = (self._w_sorted * y[..., self.perm]).transpose(0, 2, 1)
            if Sp != S:
                wy = np.concatenate(
                    [wy, np.zeros((Sp - S,) + wy.shape[1:], wy.dtype)])
            x, resids = self._solve_2d(wy)
            x, resids = x[:S], resids[:, :S]
        x = x.cpu().numpy()
        if return_resids:
            return x, resids.cpu().numpy()
        return x


def sense_recon_sharded(traj, maps, y, mesh, **kw):
    """One-shot multi-device end-to-end recon: build + solve. See
    :class:`SenseReconSharded` (reuse that for repeated acquisitions)."""
    return SenseReconSharded(traj, maps, mesh, **kw)(y)
