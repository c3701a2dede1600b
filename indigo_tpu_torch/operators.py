"""Structured linear operators as ``torch.nn.Module``s (the serving subset).

Counterpart of ``indigo_tpu/operators.py``: ``Operator`` with
``apply(x, adjoint)``, ``.H``, ``*`` composition (a scalar factor gives
``Scale``) and ``cost()``, the combinators ``Product``, ``Adjoint``,
``KronI``, ``VStack``, ``Scale`` and the leaves ``Diag``, ``GridDFT``,
``CenteredDFT``, ``Perm`` and ``SpMatrix``. Operators hold their arrays as
buffers, so ``.to(device)`` moves a whole tree. Shapes follow the
reference's matrix convention: an operator has shape (M, N) and acts on
column-batched complex64 tensors x of shape (N, K).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .sparse import (ElementELL, csr_to_bell, csr_to_element, csr_to_jag,
                     element_spmm, estimate_jag_bytes)

__all__ = ["Operator", "Diag", "GridDFT", "CenteredDFT", "Perm", "SpMatrix",
           "Product", "Adjoint", "KronI", "VStack", "Scale"]


def _is_scalar(v):
    return isinstance(v, (int, float, complex)) and not isinstance(v, bool)


class Operator(nn.Module):
    """Abstract structured linear operator (shape (M, N), column-batched)."""

    def __init__(self, name=None):
        super().__init__()
        self._name = name

    @property
    def shape(self):
        raise NotImplementedError

    def apply(self, x, adjoint=False):
        """x (N, K) -> y (M, K); adjoint applies A^H."""
        raise NotImplementedError

    def forward(self, x, adjoint=False):
        return self.apply(x, adjoint=adjoint)

    def cost(self, ncols: int = 1):
        """(flops, bytes) estimate for ONE forward apply with K columns;
        a complex multiply-add counts as 8 flops. Every leaf defines it."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no cost()")

    @property
    def H(self):
        return self.child if isinstance(self, Adjoint) else Adjoint(self)

    def __mul__(self, other):
        if isinstance(other, Operator):
            return Product(self, other)
        if _is_scalar(other):
            return Scale(other, self)
        if isinstance(other, torch.Tensor):
            was_vec = other.dim() == 1
            x = other[:, None] if was_vec else other
            if x.shape[0] != self.shape[1]:
                raise ValueError(
                    f"{self.name}: input has {x.shape[0]} rows, operator "
                    f"is {self.shape[0]}x{self.shape[1]}")
            y = self.apply(x)
            return y[:, 0] if was_vec else y
        return NotImplemented

    __matmul__ = __mul__

    def __rmul__(self, other):
        if _is_scalar(other):
            return Scale(other, self)
        return NotImplemented

    def __neg__(self):
        return Scale(-1.0, self)

    @property
    def name(self):
        return self._name or type(self).__name__

    def extra_repr(self):
        M, N = self.shape
        return f"{self.name} <{M}x{N}>"


class Diag(Operator):
    """Diagonal operator (coil maps, deapodization): buffer ``d`` (n,)."""

    def __init__(self, d, name=None):
        super().__init__(name)
        self.register_buffer("d", torch.as_tensor(np.asarray(d)).reshape(-1))

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    def apply(self, x, adjoint=False):
        d = self.d.conj() if adjoint else self.d
        return d[:, None] * x

    def cost(self, ncols=1):
        n, K, isz = self.shape[0], ncols, self.d.element_size()
        return 8 * n * K, (3 * n * K + n) * isz


class CenteredDFT(Operator):
    """(centered FFT) . (centered zero-pad) as per-axis matrix products.

    Forward maps an image to the centered spectrum on the oversampled grid;
    the adjoint crops the inverse centered DFT back to the image. Each axis
    is one (g_d, n_d) complex matrix (``ops.dft_fft.centered_pad_dft_mat``)
    with the fftshift checkerboards and the pad offset folded in.
    """

    def __init__(self, img_shape, grid_shape, name=None):
        from .ops.dft_fft import centered_pad_dft_mat

        super().__init__(name)
        self._img = tuple(int(s) for s in img_shape)
        self._grid = tuple(int(s) for s in grid_shape)
        if len(self._img) != len(self._grid):
            raise ValueError("rank mismatch")
        for n, g in zip(self._img, self._grid):
            if n > g:
                raise ValueError("img_shape must fit inside grid_shape")
            if g % 2:
                raise ValueError("centered FFT requires even grid dims")
        for d, (n, g) in enumerate(zip(self._img, self._grid)):
            m = centered_pad_dft_mat(n, g)
            self.register_buffer(f"mf{d}", torch.from_numpy(m))
            self.register_buffer(
                f"mi{d}", torch.from_numpy(np.ascontiguousarray(m.conj().T)))

    @property
    def img_shape(self):
        return self._img

    @property
    def grid_shape(self):
        return self._grid

    @property
    def shape(self):
        return (int(np.prod(self._grid)), int(np.prod(self._img)))

    def _mats(self, adjoint):
        key = "mi" if adjoint else "mf"
        return [getattr(self, f"{key}{d}") for d in range(len(self._img))]

    def apply(self, x, adjoint=False):
        from .ops.dft_fft import dft_nd_apply

        K = x.shape[1]
        src = self._grid if adjoint else self._img
        v = x.T.reshape((K,) + src).to(torch.complex64)
        return dft_nd_apply(v, self._mats(adjoint)).reshape(K, -1).T

    def cost(self, ncols=1):
        # stage d contracts g_d x n_d over a volume morphing img -> grid
        K, isz = ncols, 8
        flops = 0
        vol = int(np.prod(self._img))
        bytes_ = self.shape[1] * K * isz
        for n_, g_ in zip(self._img, self._grid):
            vol = vol // n_ * g_
            flops += 8 * vol * n_ * K
            bytes_ += 2 * vol * K * isz + n_ * g_ * isz
        return flops, bytes_


class GridDFT(CenteredDFT):
    """Fused KB gridding . centered padded DFT: the NUFFT core G Fc Z.

    Forward: per-axis centered pad+DFT matrices (``dft_nd_apply``) onto the
    oversampled grid, then the KB gather — the chain the reference writes at
    ``operators.py`` (its ``dft_nd_apply`` + ``tile_interp_apply`` branch).
    Adjoint: the KB scatter onto the natural-order grid, then the adjoint
    (conjugate-transposed) matrices. Requires the periodic no-halo tiling
    (``plan.ext == plan.grid_shape``), as the reference does.
    """

    def __init__(self, plan, img_shape, name=None):
        from .ops.tile_interp import kb_patches

        grid = tuple(int(g) for g in plan.grid_shape)
        if tuple(plan.ext) != grid:
            raise ValueError(
                "GridDFT requires the periodic no-halo tiling "
                f"(plan.ext == grid_shape), got ext={plan.ext} "
                f"grid={grid}; the KBInterp * CenteredDFT chain is not "
                "ported yet (ROADMAP Queue 1, item 6)")
        super().__init__(img_shape, grid, name)
        self._width = plan.width
        corner, wkb = kb_patches(plan)
        self.register_buffer("corner", torch.from_numpy(corner))
        self.register_buffer("wkb", torch.from_numpy(wkb))

    @property
    def shape(self):
        return (self.corner.shape[0], int(np.prod(self._img)))

    def apply(self, x, adjoint=False):
        from .ops.dft_fft import dft_nd_apply
        from .ops.tile_interp import tile_interp_apply

        K = x.shape[1]
        if not adjoint:
            v = x.T.reshape((K,) + self._img).to(torch.complex64)
            g = dft_nd_apply(v, self._mats(False))
            return tile_interp_apply(self.corner, self.wkb, self._grid, g)
        g = tile_interp_apply(self.corner, self.wkb, self._grid, x,
                              adjoint=True)
        v = dft_nd_apply(g, self._mats(True))
        return v.reshape(K, -1).T

    def cost(self, ncols=1):
        flops, bytes_ = super().cost(ncols)
        K, M = ncols, self.shape[0]
        P = self._width ** len(self._img)
        # gather/scatter: each sample touches P grid nodes of K complex
        return (flops + 8 * M * P * K,
                bytes_ + M * P * K * 8 + self.corner.nbytes
                + self.wkb.nbytes + M * K * 8)


class Perm(Operator):
    """Permutation y = x[perm]; the adjoint is the inverse gather.

    Re-tiles the oversampled grid into the Morton column order of the
    gridding SpMM (``noncart.tiled_order``); both directions are gathers.
    """

    def __init__(self, perm, name=None):
        super().__init__(name)
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        self.register_buffer("p", torch.from_numpy(perm))
        self.register_buffer("ip", torch.from_numpy(inv))

    @property
    def shape(self):
        n = self.p.shape[0]
        return (n, n)

    @property
    def perm(self):
        return self.p

    def apply(self, x, adjoint=False):
        return x.index_select(0, self.ip if adjoint else self.p)

    def cost(self, ncols=1):
        n, K = self.shape[0], ncols
        return 0, 2 * n * K * 8 + n * 4


class SpMatrix(Operator):
    """Sparse matrix leaf: block-sparse tiles for both directions.

    The scipy CSR is converted on the host once; A^H is tiled separately,
    so both directions are gathers (``ops.spmm``: kernel K3 or K4 on CUDA).
    ``format``: 'jag' (ragged blocked-CSR), 'bell' (blocked-ELL),
    'element' (exactly-nnz storage, plain gather/scatter applies), or
    'auto' — 'jag' unless both jag tilings together would exceed
    ``MAX_TILE_BYTES``, then 'element'.
    """

    MAX_TILE_BYTES = 1 << 30

    def __init__(self, A, name=None, bm=8, bn=128, format="auto",
                 _ell=None, _ellH=None):
        super().__init__(name)
        if _ell is None:
            A = sp.csr_matrix(A)
            if format == "auto":
                est = (estimate_jag_bytes(A, bm, bn)
                       + estimate_jag_bytes(A.T, bm, bn))
                format = "jag" if est <= self.MAX_TILE_BYTES else "element"
            if format == "element":
                _ell, _ellH = csr_to_element(A), None
            elif format in ("jag", "bell"):
                conv = csr_to_jag if format == "jag" else csr_to_bell
                _ell = conv(A, bm=bm, bn=bn)
                _ellH = conv(A.conj().T.tocsr(), bm=bm, bn=bn)
            else:
                raise ValueError(f"SpMatrix: unknown format {format!r}")
        self._ell = _ell
        self._ellH = _ellH

    @property
    def shape(self):
        return self._ell.shape

    @property
    def ell(self):
        return self._ell

    @property
    def ellH(self):
        return self._ellH

    def apply(self, x, adjoint=False):
        from .ops import spmm

        if isinstance(self._ell, ElementELL):
            return element_spmm(self._ell, x, adjoint=adjoint)
        return spmm(self._ellH if adjoint else self._ell, x)

    def cost(self, ncols=1):
        ell, K = self._ell, ncols
        isz = ell.data.element_size()
        flops = 8 * ell.data.numel() * K  # the whole stored tile is computed
        bytes_ = ell.memusage() + (self.shape[0] + self.shape[1]) * K * isz
        return flops, bytes_


class Product(Operator):
    """Composition A @ B."""

    def __init__(self, A, B, name=None):
        if A.shape[1] != B.shape[0]:
            raise ValueError(
                f"shape mismatch in Product: {A.shape} @ {B.shape}")
        super().__init__(name)
        self.left, self.right = A, B

    @property
    def shape(self):
        return (self.left.shape[0], self.right.shape[1])

    def apply(self, x, adjoint=False):
        if adjoint:
            return self.right.apply(self.left.apply(x, adjoint=True),
                                    adjoint=True)
        return self.left.apply(self.right.apply(x))

    def cost(self, ncols=1):
        fa, ba = self.left.cost(ncols)
        fb, bb = self.right.cost(ncols)
        return fa + fb, ba + bb


class Adjoint(Operator):
    """Conjugate-transpose wrapper (``A.H``; ``A.H.H`` is ``A``)."""

    def __init__(self, A, name=None):
        super().__init__(name)
        self.child = A

    @property
    def shape(self):
        m, n = self.child.shape
        return (n, m)

    def apply(self, x, adjoint=False):
        return self.child.apply(x, adjoint=not adjoint)

    def cost(self, ncols=1):
        return self.child.cost(ncols)


class KronI(Operator):
    """I_c (x) A: the c stacked blocks fold into the column batch, so one
    child apply serves all copies."""

    def __init__(self, c, A, name=None):
        super().__init__(name)
        self.c = int(c)
        self.child = A

    @property
    def shape(self):
        m, n = self.child.shape
        return (self.c * m, self.c * n)

    def apply(self, x, adjoint=False):
        m, n = self.child.shape
        if adjoint:
            m, n = n, m
        c, K = self.c, x.shape[1]
        xw = x.reshape(c, n, K).permute(1, 0, 2).reshape(n, c * K)
        yw = self.child.apply(xw, adjoint=adjoint)
        return yw.reshape(m, c, K).permute(1, 0, 2).reshape(c * m, K)

    def cost(self, ncols=1):
        f, b = self.child.cost(ncols)
        return self.c * f, self.c * b


class VStack(Operator):
    """[A_1; A_2; ...]: stacked outputs, shared input; the adjoint sums the
    per-block adjoints."""

    def __init__(self, blocks, name=None):
        super().__init__(name)
        blocks = list(blocks)
        if not blocks:
            raise ValueError("VStack needs at least one block")
        n = blocks[0].shape[1]
        if any(b.shape[1] != n for b in blocks):
            raise ValueError("VStack blocks must share input width")
        self.blocks = nn.ModuleList(blocks)

    @property
    def shape(self):
        return (sum(b.shape[0] for b in self.blocks),
                self.blocks[0].shape[1])

    def apply(self, x, adjoint=False):
        if adjoint:
            y = None
            off = 0
            for b in self.blocks:
                m = b.shape[0]
                t = b.apply(x[off:off + m], adjoint=True)
                y = t if y is None else y + t
                off += m
            return y
        return torch.cat([b.apply(x) for b in self.blocks], dim=0)

    def cost(self, ncols=1):
        f = b = 0
        for c in self.blocks:
            cf, cb = c.cost(ncols)
            f += cf
            b += cb
        return f, b


class Scale(Operator):
    """alpha * A for a scalar alpha; the adjoint scales by conj(alpha)."""

    def __init__(self, alpha, A, name=None):
        super().__init__(name)
        self.alpha = alpha.item() if hasattr(alpha, "item") else alpha
        self.child = A

    @property
    def shape(self):
        return self.child.shape

    def apply(self, x, adjoint=False):
        a = self.alpha.conjugate() if adjoint else self.alpha
        return a * self.child.apply(x, adjoint=adjoint)

    def cost(self, ncols=1):
        return self.child.cost(ncols)
