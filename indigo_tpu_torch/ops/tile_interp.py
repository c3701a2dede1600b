"""Kaiser-Bessel gridding G and its adjoint (torch), from a host tile plan.

Counterpart of ``indigo_tpu/ops/tile_interp.py``. The host plan
(:func:`plan_tile_interp`) is a numpy copy of the reference's in its
``adjoint="scatter"``, ``forward="dense"`` form: same per-sample tile ids
``tid``, factored KB weights ``wfac``, geometry and — with ``reorder=True``
under the default ``forward="grouped"`` — the same group-major sample
permutation, so sample order (and with it the user-order I/O of the SENSE
pipeline) is identical to the reference's.

The reference's tile-binned adjoint and span-grouped forward were built
around the cost of TPU scatters and row gathers; they are not ported. The
torch apply works on the natural-order oversampled grid instead: each
sample's width^d patch is recovered from the plan as a corner index and
width weights per axis (:func:`kb_patches`), the forward is one gather and
a weighted sum, the adjoint one ``index_add_``. Both are chunked over
samples so the expanded (samples x width^d x K) scratch stays bounded.
The sums run in another order than the reference's, so results agree to
f32 rounding, not bitwise.

Layouts of :func:`kb_gather` / :func:`kb_scatter`: the grid is
(K, *grid_shape) complex64 (K batch columns leading), samples are (M, K)
complex64 in plan sample order. :func:`tile_interp_apply` is the
reference-shaped entry over them: ``(plan, x)`` with the grid as (N, K).
"""
from __future__ import annotations

import numpy as np
import torch

from ..noncart import DEFAULT_TILES as DEFAULT_TILE
from .dft_fft import full_f32_matmul

__all__ = ["TileInterpPlan", "plan_tile_interp", "kb_patches", "kb_gather",
           "kb_scatter", "tile_interp_apply", "DEFAULT_TILE"]

# expanded-scratch bound of one sample chunk, in float32 elements (256 MB)
_SCRATCH_ELEMS = 1 << 26

_NO_TILED_LAYOUT = (
    "the reference's tile-binned adjoint layout (TileAdjBins, bin_layout) "
    "and span-grouped forward groups (FwdGroups) are the TPU's 128-lane "
    "tiled-grid layout, which the port does not build: it grids on the "
    "natural-order grid (kb_gather / kb_scatter)")


class TileInterpPlan:
    """Host-built tile geometry (numpy), the reference plan's dense form.

    tid: (M, S) int32 tile ids of each sample's super-tile; wfac: nd arrays
    (M, n_d, t_d) float32, per-axis KB weights scattered into super-tile
    extent position; grid_shape, tile, ext (halo-extended dims), nt (tiles
    per axis), pad_lo (halo below), width; sample_perm (None when identity).
    The reference's ``bins`` and ``fgroups`` are accepted as None only.
    """

    def __init__(self, tid, wfac, grid_shape, tile, ext, nt, pad_lo, width,
                 bins=None, fgroups=None, sample_perm=None):
        if bins is not None or fgroups is not None:
            raise ValueError(f"TileInterpPlan(bins=, fgroups=): "
                             f"{_NO_TILED_LAYOUT}")
        self.tid = np.asarray(tid)
        self.wfac = tuple(np.asarray(w) for w in wfac)
        self.sample_perm = sample_perm
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.tile = tuple(int(t) for t in tile)
        self.ext = tuple(int(e) for e in ext)
        self.nt = tuple(int(n) for n in nt)
        self.pad_lo = tuple(int(p) for p in pad_lo)
        self.width = int(width)

    @property
    def n_samples(self):
        return self.tid.shape[0]

    @property
    def S(self):
        return self.tid.shape[1]

    def memusage(self):
        """Bytes of the plan's arrays, ``tid`` and ``wfac``."""
        return self.tid.nbytes + sum(int(w.nbytes) for w in self.wfac)


def plan_tile_interp(traj, grid_shape, width=4, beta=None, tile=None,
                     adjoint="binned", forward="grouped", reorder=False,
                     bin_layout=None):
    """Build a :class:`TileInterpPlan` (host-side, vectorized numpy).

    The reference's signature and defaults. Every ``adjoint`` in
    {"binned", "scatter"} and ``forward`` in {"grouped", "dense"} builds the
    port's one plan, the reference's scatter/dense form: same geometry and
    weights. ``forward`` still decides the sample order, as there:
    ``reorder=True`` applies the reference's group-major permutation only
    under ``forward="grouped"`` and leaves the order alone under
    ``"dense"``; the permutation is exposed as ``plan.sample_perm`` (None
    when identity) and the caller composes it into its own sample mapping.
    ``adjoint="layout"`` and a ``bin_layout`` ask for the TPU's tiled bin
    layout and raise ValueError.
    """
    from ..noncart import kaiser_bessel, beatty_beta

    if forward not in ("grouped", "dense"):
        raise ValueError(f"plan_tile_interp: unknown forward={forward!r}")
    if adjoint not in ("binned", "scatter") or bin_layout is not None:
        raise ValueError(f"plan_tile_interp(adjoint={adjoint!r}, "
                         f"bin_layout=...): {_NO_TILED_LAYOUT}")

    traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
    M, nd = traj.shape
    G = tuple(int(g) for g in grid_shape)
    assert len(G) == nd, (G, nd)
    if beta is None:
        beta = beatty_beta(width, 2.0)
    if tile is None:
        tile = DEFAULT_TILE[nd]
    tile = tuple(int(t) for t in tile)
    assert int(np.prod(tile)) == 128, tile

    pad_lo, ext, nt, nsup = [], [], [], []
    tblk, wfac, touch_d, wrap_d = [], [], [], []
    for d in range(nd):
        t = tile[d]
        c = (traj[:, d] + 0.5) * G[d]
        base = np.ceil(c - width / 2.0).astype(np.int64)
        offs = np.arange(width)
        w_d = kaiser_bessel(c[:, None] - (base[:, None] + offs[None, :]),
                            width, beta).astype(np.float32)
        n_d = (t - 1 + width - 1) // t + 1   # super-tile tiles along axis
        if G[d] % t == 0:
            # periodic tile grid: member tile ids wrap mod nt, no halo
            lo = 0
            ntd = G[d] // t
            e = G[d]
            tb = np.floor_divide(base, t)
            off_in = base - tb * t
            wrap = True
        else:
            lo = int(max(0, -base.min()))
            basep = base + lo
            hi_need = int(basep.max()) + width
            ntd = -(-hi_need // t)
            ntd = max(ntd, (int(basep.max()) // t) + n_d)
            ntd = max(ntd, -(-(G[d] + lo) // t))
            e = ntd * t
            tb = basep // t
            off_in = basep - tb * t
            wrap = False
        wf = np.zeros((M, n_d * t), dtype=np.float32)
        np.put_along_axis(wf, off_in[:, None] + offs[None, :], w_d, axis=1)
        pad_lo.append(lo)
        ext.append(e)
        nt.append(ntd)
        nsup.append(n_d)
        tblk.append(tb)
        wfac.append(wf.reshape(M, n_d, t))
        wrap_d.append(wrap)
        j = np.arange(n_d)
        touch_d.append((off_in[:, None] < (j[None, :] + 1) * t)
                       & (off_in[:, None] + width > j[None, :] * t))

    sample_perm = None
    if reorder and forward == "grouped":
        # group-major order by per-axis span counts (reference: the grouped
        # forward's sample order, plan_tile_interp(reorder=True))
        code = np.zeros(M, dtype=np.int64)
        for d in range(nd):
            code = code * nsup[d] + (touch_d[d].sum(axis=1) - 1)
        order = np.argsort(code, kind="stable")
        if not np.array_equal(order, np.arange(M)):
            sample_perm = order
            wfac = [w[order] for w in wfac]
            tblk = [t[order] for t in tblk]

    grids = np.indices(tuple(nsup)).reshape(nd, -1)       # (d, S)
    step = np.ones(nd, dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        step[d] = step[d + 1] * nt[d + 1]
    tid = np.zeros((M, grids.shape[1]), dtype=np.int64)
    for d in range(nd):
        md = tblk[d][:, None] + grids[d][None, :]
        if wrap_d[d]:
            md %= nt[d]
        tid += md * step[d]

    return TileInterpPlan(
        tid=tid.astype(np.int32), wfac=wfac, grid_shape=G, tile=tile,
        ext=tuple(ext), nt=tuple(nt), pad_lo=tuple(pad_lo), width=width,
        sample_perm=sample_perm)


def kb_patches(plan):
    """Per-sample KB patches of a tile plan on the natural-order grid.

    Returns ``(corner, wkb)``: corner (M, nd) int64 grid index of each
    patch's first node per axis (taken mod grid_shape when applied) and
    wkb (M, nd, width) float32 weights. Recovered from ``tid``/``wfac``
    alone, so a plan carried over from the reference gives the same
    patches: the patch starts at the first nonzero super-tile weight (KB
    weights are > 0 on the whole patch) inside member tile 0, whose per-axis
    tile index is decoded from ``tid[:, 0]``.
    """
    nd = len(plan.grid_shape)
    w = plan.width
    step = np.ones(nd, dtype=np.int64)
    for d in range(nd - 2, -1, -1):
        step[d] = step[d + 1] * plan.nt[d + 1]
    t0 = plan.tid[:, 0].astype(np.int64)
    M = plan.n_samples
    corner = np.empty((M, nd), dtype=np.int64)
    wkb = np.empty((M, nd, w), dtype=np.float32)
    for d in range(nd):
        tb = (t0 // step[d]) % plan.nt[d]
        wf = plan.wfac[d].reshape(M, -1)
        off = np.argmax(wf > 0, axis=1)
        if not np.all(wf[np.arange(M), off] > 0):
            raise ValueError(f"plan axis {d}: a sample has no KB weight")
        corner[:, d] = tb * plan.tile[d] + off - plan.pad_lo[d]
        wkb[:, d] = np.take_along_axis(
            wf, off[:, None] + np.arange(w)[None, :], axis=1)
    return corner, wkb


def _patch_index_weights(corner, wkb, grid_shape):
    """Flat natural-grid node ids (m, P) and weights (m, P), P = width^nd."""
    nd = len(grid_shape)
    w = wkb.shape[-1]
    offs = torch.arange(w, device=corner.device)
    idx = None
    W = None
    for d in range(nd):
        i_d = torch.remainder(corner[:, d:d + 1] + offs[None, :],
                              grid_shape[d])               # (m, w)
        shape = (-1,) + (1,) * d + (w,) + (1,) * (nd - 1 - d)
        i_d = i_d.reshape(shape)
        w_d = wkb[:, d].reshape(shape)
        idx = i_d if idx is None else idx * grid_shape[d] + i_d
        W = w_d if W is None else W * w_d
    m = corner.shape[0]
    return idx.reshape(m, -1), W.reshape(m, -1)


def _chunk(chunk, P, K):
    return max(1024, _SCRATCH_ELEMS // (P * 2 * K)) if chunk is None \
        else int(chunk)


def kb_gather(corner, wkb, grid_shape, x, chunk=None):
    """G: grid x (K, *grid_shape) complex -> samples (M, K).

    corner/wkb: tensors from :func:`kb_patches` on x's device. ``chunk``
    (samples per step) bounds the expanded scratch; default keeps it near
    256 MB.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    N = int(np.prod(grid_shape))
    M = corner.shape[0]
    P = wkb.shape[-1] ** len(grid_shape)
    x = x.to(torch.complex64)
    assert tuple(x.shape[1:]) == grid_shape, (x.shape, grid_shape)
    K = x.shape[0]
    chunk = _chunk(chunk, P, K)
    if x.is_cuda:
        full_f32_matmul()
    xr = torch.view_as_real(x.reshape(K, N))               # (K, N, 2)
    y = torch.empty((M, K, 2), dtype=torch.float32, device=x.device)
    for lo in range(0, M, chunk):
        hi = min(M, lo + chunk)
        idx, W = _patch_index_weights(corner[lo:hi], wkb[lo:hi], grid_shape)
        g = xr.index_select(1, idx.reshape(-1)).reshape(K, hi - lo, P, 2)
        y[lo:hi] = torch.einsum("kmpr,mp->mkr", g, W)
    return torch.view_as_complex(y)


def kb_scatter(corner, wkb, grid_shape, x, chunk=None):
    """G^H: samples x (M, K) complex -> grid (K, *grid_shape), one
    ``index_add_`` per sample chunk; patch nodes outside the grid fold back
    periodically (they are taken mod grid_shape)."""
    grid_shape = tuple(int(g) for g in grid_shape)
    N = int(np.prod(grid_shape))
    M = corner.shape[0]
    P = wkb.shape[-1] ** len(grid_shape)
    x = x.to(torch.complex64)
    assert x.shape[0] == M, (x.shape, M)
    K = x.shape[1]
    chunk = _chunk(chunk, P, K)
    out = torch.zeros((K, N, 2), dtype=torch.float32, device=x.device)
    yr = torch.view_as_real(x)                             # (M, K, 2)
    for lo in range(0, M, chunk):
        hi = min(M, lo + chunk)
        idx, W = _patch_index_weights(corner[lo:hi], wkb[lo:hi], grid_shape)
        src = W[None, :, :, None] * yr[lo:hi].transpose(0, 1)[:, :, None]
        out.index_add_(1, idx.reshape(-1), src.reshape(K, -1, 2))
    return torch.view_as_complex(out).reshape((K,) + grid_shape)


def tile_interp_apply(plan, x, adjoint=False, chunk=None, device=None):
    """Apply the gridding interpolation G of a tile plan (or its adjoint),
    with the reference's signature and layouts.

    Forward: x (N, K) grid -> (M, K) samples. Adjoint: x (M, K) samples ->
    (N, K) grid. x is a tensor (the result lives on its device) or host
    data (narrowed and put on ``device``, by default the card:
    ``utils.as_tensor``); a real x gives a real result. A
    call-compatibility entry: it
    derives the plan's patches and moves them to x's device on every call.
    Operators hold the patches as buffers and call :func:`kb_gather` /
    :func:`kb_scatter` directly.
    """
    from ..utils import as_tensor

    x = as_tensor(x, device)
    corner, wkb = (torch.from_numpy(a).to(x.device)
                   for a in kb_patches(plan))
    K = x.shape[1]
    if adjoint:
        y = kb_scatter(corner, wkb, plan.grid_shape, x,
                       chunk=chunk).reshape(K, -1).T
    else:
        g = x.T.reshape((K,) + tuple(plan.grid_shape))
        y = kb_gather(corner, wkb, plan.grid_shape, g, chunk=chunk)
    return y if x.is_complex() else y.real
