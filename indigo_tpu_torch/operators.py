"""Structured linear operators as ``torch.nn.Module``s.

Counterpart of ``indigo_tpu/operators.py``: ``Operator`` with
``apply(x, adjoint)``, ``.H``, ``*`` composition (a scalar factor gives
``Scale``), ``cost()`` and the reference's introspection surface
(``dtype``, ``children()``, ``dump()``, ``memusage()``, ``to_dense()``,
``eval()``, ``optimize()``); the leaves ``SpMatrix``, ``KBInterp``,
``DenseMatrix``, ``Diag``, ``UnscaledFFT``, ``CenteredDFT``, ``GridDFT``,
``Eye``, ``One``, ``CropPad``, ``Perm``, ``Mask`` and the combinators
``Product``, ``Adjoint``, ``KronI``, ``BlockDiag``, ``VStack``, ``HStack``,
``Scale``. Operators hold their arrays as buffers, so ``.to(device)`` moves
a whole tree. Shapes follow the reference's matrix convention: an operator
has shape (M, N) and acts on column-batched complex64 tensors x of shape
(N, K). The attribute names the rewrite passes read (``left``/``right``,
``child``, ``c``, ``alpha``, ``blocks``, ``payload``, ``keep``, ``_name``)
are the reference's.

Every leaf takes ``device``. A leaf that holds arrays builds them there
(``utils.as_tensor``): host data goes to the card unless ``device`` names
another, 64-bit host floats are narrowed to 32-bit as the reference's
boundary narrows them, and a leaf built from tensors stays on their device
unless ``device`` is given. A leaf without arrays (``UnscaledFFT``,
``Eye``, ``One``, ``CropPad``) records a given ``device``; a numpy operand
of a tree goes to the tree's device, and to the card for a tree that holds
no arrays and records none.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .sparse import (ElementELL, csr_to_bell, csr_to_element, csr_to_jag,
                     element_spmm, estimate_jag_bytes)
from .utils import as_dtype, as_tensor, default_device

__all__ = [
    "Operator",
    "SpMatrix", "KBInterp", "DenseMatrix", "Diag", "UnscaledFFT",
    "CenteredDFT", "GridDFT", "Eye", "One", "CropPad", "Perm", "Mask",
    "Product", "Adjoint", "KronI", "BlockDiag", "VStack", "HStack", "Scale",
]


def _is_scalar(v):
    return isinstance(v, (int, float, complex)) and not isinstance(v, bool)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


class Operator(nn.Module):
    """Abstract structured linear operator (shape (M, N), column-batched).

    An Operator is an ``nn.Module`` (buffers, ``.to()``, ``state_dict()``)
    and also carries the reference's operator surface, which reuses three
    of ``nn.Module``'s names. They live together like this:

    * ``apply(x, adjoint=False)`` is the operator apply; ``nn.Module``'s
      ``apply(fn)`` is not available on operators.
    * ``children()`` returns the *operator* children as a tuple (what the
      rewrite passes and ``dump()`` walk; a leaf has none). Sub-modules that
      are not operators (the sparse formats of an ``SpMatrix``, the
      ``ModuleList`` of a stack) stay registered sub-modules, so
      ``modules()``, ``buffers()`` and ``state_dict()`` see them; ``.to()``
      and its relatives (``_apply``) and ``train()`` are overridden here to
      walk the registered sub-modules rather than ``children()``.
    * ``eval(x, alpha, beta, y, forward)`` is the reference's functional
      alpha * op(x) + beta * y; called with no ``x`` it is ``nn.Module``'s
      ``eval()`` (``train(False)``).
    """

    def __init__(self, name=None):
        super().__init__()
        self._name = name

    # ---- core contract -------------------------------------------------
    @property
    def shape(self):
        raise NotImplementedError

    @property
    def dtype(self):
        return torch.complex64

    @property
    def device(self):
        """Device of the tree's first buffer; None for a tree without
        arrays (it follows its input)."""
        for t in self.buffers():
            return t.device
        return None

    def _record_device(self, device):
        """An array-less leaf built with ``device`` keeps it in an empty,
        non-persistent buffer (``.to()`` moves it, ``state_dict`` leaves it
        out), so that its tree has a device."""
        if device is not None:
            self.register_buffer("_where", torch.empty(0, device=device),
                                 persistent=False)

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

    def _isz(self):
        return torch.empty(0, dtype=self.dtype).element_size()

    # ---- nn.Module walks over the registered sub-modules ---------------
    def _apply(self, fn, recurse=True):
        if recurse:
            for m in self._modules.values():
                if m is not None:
                    m._apply(fn)
        return super()._apply(fn, recurse=False)

    def train(self, mode=True):
        if not isinstance(mode, bool):
            raise ValueError("training mode is expected to be boolean")
        for m in self.modules():
            m.training = mode
        return self

    # ---- reference-compatible surface ----------------------------------
    def eval(self, x=None, alpha=1.0, beta=0.0, y=None, forward=True):
        """y' = alpha * op(x) + beta * y (``forward=False``: op^H); with no
        ``x``, ``nn.Module.eval()``."""
        if x is None:
            return self.train(False)
        x, was_vec = self._operand(x)
        out = alpha * self.apply(x, adjoint=not forward)
        if y is not None:
            yv, _ = self._operand(y)
            out = out + beta * yv
        return out[:, 0] if was_vec else out

    def _operand(self, x):
        """(x as a 2-D tensor, was it 1-D): a tensor as it is, host data
        through ``utils.as_tensor`` to the operator's device (the card for
        a tree without one)."""
        if not torch.is_tensor(x):
            x = as_tensor(x, device=self.device)
        return (x[:, None], True) if x.dim() == 1 else (x, False)

    @property
    def H(self):
        return Adjoint(self)

    def __mul__(self, other):
        if isinstance(other, Operator):
            return Product(self, other)
        if _is_scalar(other):
            return Scale(other, self)
        if not isinstance(other, (torch.Tensor, np.ndarray)):
            return NotImplemented
        x, was_vec = self._operand(other)
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"{self.name}: input has {x.shape[0]} rows, operator "
                f"is {self.shape[0]}x{self.shape[1]}")
        y = self.apply(x)
        return y[:, 0] if was_vec else y

    __matmul__ = __mul__

    def __rmul__(self, other):
        if _is_scalar(other):
            return Scale(other, self)
        return NotImplemented

    def __neg__(self):
        return Scale(-1.0, self)

    # numpy must not take ``ndarray * op`` or ``op * ndarray`` elementwise
    __array_ufunc__ = None

    # ---- introspection -------------------------------------------------
    @property
    def name(self):
        return self._name or type(self).__name__

    def children(self):
        return tuple(m for m in self._modules.values()
                     if isinstance(m, Operator))

    def _describe(self):
        M, N = self.shape
        return f"{self.name} <{M}x{N}> {_dtype_name(self.dtype)}"

    def dump(self, _indent=0):
        """Pretty-print the operator tree, one node per line."""
        lines = ["  " * _indent + self._describe()]
        for c in self.children():
            lines.append(c.dump(_indent + 1))
        return "\n".join(lines)

    def memusage(self):
        """Total bytes of the arrays held in the tree."""
        return int(sum(b.numel() * b.element_size() for b in self.buffers()))

    def optimize(self, recipe=None):
        """Run the rewrite pipeline (``transforms.optimize``)."""
        from .transforms import optimize as _optimize
        return _optimize(self, recipe)

    def to_dense(self):
        """Materialise as a dense matrix by applying to the identity
        (tests)."""
        eye = torch.eye(self.shape[1], dtype=self.dtype,
                        device=default_device(self.device))
        return self.apply(eye)

    def extra_repr(self):
        M, N = self.shape
        return f"{self.name} <{M}x{N}>"


# =========================== leaves ====================================


class SpMatrix(Operator):
    """Sparse matrix leaf: block-sparse tiles for both directions.

    The scipy CSR is converted on the host once; A^H is tiled separately,
    so both directions are gathers (``ops.spmm``: kernel K3 or K4 on CUDA),
    and each is the other's gradient in x.
    ``format``: 'jag' (ragged blocked-CSR), 'bell' (blocked-ELL),
    'element' (exactly-nnz storage, plain gather/scatter applies), or
    'auto' — 'jag' unless both jag tilings together would exceed
    ``MAX_TILE_BYTES``, then 'element'.
    """

    MAX_TILE_BYTES = 1 << 30

    def __init__(self, A, name=None, bm=8, bn=128, format="auto",
                 _ell=None, _ellH=None, device=None):
        super().__init__(name)
        if _ell is None:
            device = default_device(device)
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
        if device is not None:
            self.to(device)

    @property
    def shape(self):
        return self._ell.shape

    @property
    def dtype(self):
        return self._ell.dtype

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
        A, AH = ((self._ellH, self._ell) if adjoint
                 else (self._ell, self._ellH))
        return spmm(A, x, AH=AH)

    def cost(self, ncols=1):
        ell, K = self._ell, ncols
        isz = ell.data.element_size()
        flops = 8 * ell.data.numel() * K  # the whole stored tile is computed
        bytes_ = ell.memusage() + (self.shape[0] + self.shape[1]) * K * isz
        return flops, bytes_

    def _describe(self):
        return (f"{super()._describe()} nnz={self._ell.nnz} "
                f"fill={self._ell.fill_fraction():.3f}")


class KBInterp(Operator):
    """Kaiser-Bessel gridding interpolation leaf G: grid -> samples.

    Built from a host tile plan (``ops.tile_interp.plan_tile_interp``);
    weights and geometry agree with ``noncart.interp_mat`` to f32 rounding.
    The apply works on the natural-order grid with each patch's nodes taken
    mod ``grid_shape`` (``ops.tile_interp.kb_gather`` / ``kb_scatter``), so
    a plan whose tiling carries a halo (``plan.ext != plan.grid_shape``)
    folds back periodically, as the reference's untiling does.
    """

    def __init__(self, plan, name=None, device=None):
        from .ops.tile_interp import kb_patches

        super().__init__(name)
        self._plan = plan
        self._grid = tuple(int(g) for g in plan.grid_shape)
        device = default_device(device)
        corner, wkb = kb_patches(plan)
        self.register_buffer("corner", as_tensor(corner, device))
        self.register_buffer("wkb", as_tensor(wkb, device))

    @property
    def plan(self):
        return self._plan

    @property
    def shape(self):
        return (self.corner.shape[0], int(np.prod(self._grid)))

    @property
    def dtype(self):
        return torch.float32

    def apply(self, x, adjoint=False):
        from .ops.tile_interp import kb_gather, kb_scatter

        K = x.shape[1]
        if adjoint:
            g = kb_scatter(self.corner, self.wkb, self._grid, x)
            return g.reshape(K, -1).T
        return kb_gather(self.corner, self.wkb, self._grid,
                         x.T.reshape((K,) + self._grid))

    def cost(self, ncols=1):
        # gather/scatter: each sample touches P grid nodes of K complex
        M, N = self.shape
        K, P = ncols, self._plan.width ** len(self._grid)
        return (8 * M * P * K,
                M * P * K * 8 + self.corner.nbytes + self.wkb.nbytes
                + (M + N) * K * 8)

    def _describe(self):
        return (f"{super()._describe()} width={self._plan.width} "
                f"payload={self.memusage() / 1e6:.0f}MB")


class DenseMatrix(Operator):
    """Dense matrix leaf: buffer ``A`` (m, n); full-f32 products (TF32
    off), as the reference's ``precision="highest"``."""

    def __init__(self, A, name=None, device=None):
        super().__init__(name)
        A = as_tensor(A, device)
        if A.dim() != 2:
            raise ValueError("DenseMatrix expects a 2D array")
        self.register_buffer("A", A)

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def array(self):
        return self.A

    def apply(self, x, adjoint=False):
        from .ops.dft_fft import full_f32_matmul

        if x.is_cuda:
            full_f32_matmul()
        A = self.A.conj().T if adjoint else self.A
        dt = torch.promote_types(A.dtype, x.dtype)
        return torch.matmul(A.to(dt), x.to(dt))

    def cost(self, ncols=1):
        m, n = self.shape
        K, isz = ncols, self._isz()
        return 8 * m * n * K, (m * n + (m + n) * K) * isz


class Diag(Operator):
    """Diagonal operator (coil maps, deapodization, FFT shifts): buffer
    ``d`` (n,)."""

    def __init__(self, d, name=None, device=None):
        super().__init__(name)
        self.register_buffer("d", as_tensor(d, device).reshape(-1))

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def payload(self):
        return self.d

    diagonal = payload

    def apply(self, x, adjoint=False):
        d = self.d.conj() if adjoint else self.d
        return d[:, None] * x

    def cost(self, ncols=1):
        n, K, isz = self.shape[0], ncols, self.d.element_size()
        return 8 * n * K, (3 * n * K + n) * isz


class UnscaledFFT(Operator):
    """Unnormalised FFT over a volume; columns are the batch dimension.

    Forward is the unnormalised DFT, the adjoint the unnormalised inverse
    (N * ifftn), so A^H A = N * I. ``torch.fft`` (cuFFT on the card), as
    the reference leaves this transform to its library; the K columns go in
    front before the transform, so every transformed axis is contiguous.
    """

    def __init__(self, vol_shape, dtype=torch.complex64, name=None,
                 device=None):
        super().__init__(name)
        self._vol = tuple(int(s) for s in vol_shape)
        self._dtype = as_dtype(dtype)
        self._record_device(device)

    @property
    def vol_shape(self):
        return self._vol

    @property
    def shape(self):
        n = int(np.prod(self._vol))
        return (n, n)

    @property
    def dtype(self):
        return self._dtype

    def apply(self, x, adjoint=False):
        K = x.shape[1]
        axes = tuple(range(1, 1 + len(self._vol)))
        v = x.T.reshape((K,) + self._vol)
        if adjoint:
            # norm="forward" leaves the inverse unscaled: N * ifftn
            y = torch.fft.ifftn(v, dim=axes, norm="forward")
        else:
            y = torch.fft.fftn(v, dim=axes)
        return y.reshape(K, -1).T.to(self._dtype)

    def cost(self, ncols=1):
        n, K, isz = int(np.prod(self._vol)), ncols, self._isz()
        flops = 5 * n * max(1, int(np.log2(max(n, 2)))) * K * 2
        return flops, 2 * 2 * n * K * isz  # read+write, ~2 passes

    def _describe(self):
        return f"{self.name}{list(self._vol)} <{self.shape[0]}x{self.shape[1]}>"


class CenteredDFT(Operator):
    """(centered FFT) . (centered zero-pad) as per-axis matrix products.

    Forward maps an image to the centered spectrum on the oversampled grid;
    the adjoint crops the inverse centered DFT back to the image. Each axis
    is one (g_d, n_d) complex matrix (``ops.dft_fft.centered_pad_dft_mat``)
    with the fftshift checkerboards and the pad offset folded in. On the
    card the adjoint runs the hand-written kernel of ``ops.pad_dft_cuda``
    (one FFT pass per axis) wherever it plans the shapes.
    """

    def __init__(self, img_shape, grid_shape, name=None, device=None):
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
        device = default_device(device)
        for d, (n, g) in enumerate(zip(self._img, self._grid)):
            m = centered_pad_dft_mat(n, g)
            self.register_buffer(f"mf{d}", as_tensor(m, device))
            self.register_buffer(
                f"mi{d}", as_tensor(np.ascontiguousarray(m.conj().T), device))

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

    def _adjoint(self, g):
        """Image (K, *img) from the grid g (K, *grid): the hand-written
        kernel (``ops.pad_dft_cuda``) where it serves these shapes on g's
        device, the adjoint matrices otherwise (the CPU, other shapes)."""
        from .ops.dft_fft import dft_nd_apply
        from .ops.pad_dft_cuda import pad_dft_serves, pad_idft_cuda

        if pad_dft_serves(self._img, self._grid, g.device):
            return pad_idft_cuda(g.contiguous(), self._img)
        return dft_nd_apply(g, self._mats(True))

    def apply(self, x, adjoint=False):
        from .ops.dft_fft import dft_nd_apply

        K = x.shape[1]
        src = self._grid if adjoint else self._img
        v = x.T.reshape((K,) + src).to(torch.complex64)
        if adjoint:
            return self._adjoint(v).reshape(K, -1).T
        return dft_nd_apply(v, self._mats(False)).reshape(K, -1).T

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

    def _describe(self):
        return (f"{self.name}{list(self._img)}->{list(self._grid)} "
                f"<{self.shape[0]}x{self.shape[1]}>")


class GridDFT(CenteredDFT):
    """Fused KB gridding . centered padded DFT: the NUFFT core G Fc Z.

    Forward: per-axis centered pad+DFT matrices (``dft_nd_apply``) onto the
    oversampled grid, then the KB gather — the chain the reference writes at
    ``operators.py`` (its ``dft_nd_apply`` + ``tile_interp_apply`` branch).
    Adjoint: the KB scatter onto the natural-order grid, then the adjoint
    pad-DFT (``CenteredDFT._adjoint``: the kernel on the card, the
    conjugate-transposed matrices elsewhere). Requires the periodic no-halo tiling
    (``plan.ext == plan.grid_shape``), as the reference does; other grids
    take ``KBInterp * CenteredDFT`` (``models.sense.nufft_op``).
    """

    def __init__(self, plan, img_shape, name=None, device=None):
        from .ops.tile_interp import kb_patches

        grid = tuple(int(g) for g in plan.grid_shape)
        if tuple(plan.ext) != grid:
            raise ValueError(
                "GridDFT requires the periodic no-halo tiling "
                f"(plan.ext == grid_shape), got ext={plan.ext} "
                f"grid={grid}; use KBInterp * CenteredDFT instead")
        device = default_device(device)
        super().__init__(img_shape, grid, name, device)
        self._plan = plan
        self._width = plan.width
        corner, wkb = kb_patches(plan)
        self.register_buffer("corner", as_tensor(corner, device))
        self.register_buffer("wkb", as_tensor(wkb, device))

    @property
    def plan(self):
        return self._plan

    @property
    def shape(self):
        return (self.corner.shape[0], int(np.prod(self._img)))

    def apply(self, x, adjoint=False):
        from .ops.dft_fft import dft_nd_apply
        from .ops.tile_interp import kb_gather, kb_scatter

        K = x.shape[1]
        if not adjoint:
            v = x.T.reshape((K,) + self._img).to(torch.complex64)
            g = dft_nd_apply(v, self._mats(False))
            return kb_gather(self.corner, self.wkb, self._grid, g)
        g = kb_scatter(self.corner, self.wkb, self._grid, x)
        return self._adjoint(g).reshape(K, -1).T

    def cost(self, ncols=1):
        flops, bytes_ = super().cost(ncols)
        K, M = ncols, self.shape[0]
        P = self._width ** len(self._img)
        # gather/scatter: each sample touches P grid nodes of K complex
        return (flops + 8 * M * P * K,
                bytes_ + M * P * K * 8 + self.corner.nbytes
                + self.wkb.nbytes + M * K * 8)

    def _describe(self):
        return f"{super()._describe()} width={self._width}"


class Eye(Operator):
    """Identity."""

    def __init__(self, n, dtype=torch.complex64, name=None, device=None):
        super().__init__(name)
        self._n = int(n)
        self._dtype = as_dtype(dtype)
        self._record_device(device)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._dtype

    def apply(self, x, adjoint=False):
        return x

    def cost(self, ncols=1):
        return 0, 0


class One(Operator):
    """All-ones (M, N) matrix: every output row is the column sum of x
    (the reference's coil-combination "sum" stage)."""

    def __init__(self, shape, dtype=torch.complex64, name=None,
                 device=None):
        super().__init__(name)
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = as_dtype(dtype)
        self._record_device(device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    def apply(self, x, adjoint=False):
        M, N = self._shape
        s = x.sum(dim=0, keepdim=True).to(self._dtype)
        return s.expand(N if adjoint else M, x.shape[1]).contiguous()

    def cost(self, ncols=1):
        m, n = self.shape
        K, isz = ncols, self._isz()
        return 2 * (m + n) * K, (m + n) * K * isz


class Perm(Operator):
    """Permutation y = x[perm]; the adjoint is the inverse gather.

    Re-tiles the oversampled grid into the Morton column order of the
    gridding SpMM (``noncart.tiled_order``); both directions are gathers.
    """

    def __init__(self, perm, dtype=torch.complex64, name=None, device=None):
        super().__init__(name)
        device = default_device(device)
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        self.register_buffer("p", as_tensor(perm, device))
        self.register_buffer("ip", as_tensor(inv, device))
        self._dtype = as_dtype(dtype)

    @property
    def shape(self):
        n = self.p.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def perm(self):
        return self.p

    def apply(self, x, adjoint=False):
        return x.index_select(0, self.ip if adjoint else self.p)

    def cost(self, ncols=1):
        n, K = self.shape[0], ncols
        return 0, 2 * n * K * 8 + n * 4


class Mask(Operator):
    """Row-selection operator (m, n): y = x[keep]; the adjoint zero-fills.

    The structured form of a 0/1 sampling matrix. Forward is one row
    gather; the adjoint writes the kept rows into a zero (n, K) tensor with
    ``index_copy_`` — ``keep`` holds every index at most once, so no two
    writes meet and the result is deterministic without atomics.
    """

    def __init__(self, keep, n, dtype=torch.complex64, name=None,
                 device=None):
        super().__init__(name)
        device = default_device(device)
        keep = np.asarray(keep).ravel().astype(np.int64)
        n = int(n)
        if keep.size and (keep.min() < 0 or keep.max() >= n):
            raise ValueError("keep indices out of range")
        if len(np.unique(keep)) != len(keep):
            raise ValueError("keep indices must be unique")
        self.register_buffer("_keep", as_tensor(keep, device))
        self._n = n
        self._dtype = as_dtype(dtype)

    @classmethod
    def from_bool(cls, mask, dtype=torch.complex64, name=None, device=None):
        """Build from a boolean array over the grid (any shape)."""
        mask = np.asarray(mask)
        return cls(np.flatnonzero(mask.ravel()), mask.size, dtype=dtype,
                   name=name, device=device)

    @property
    def shape(self):
        return (int(self._keep.shape[0]), self._n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def keep(self):
        return self._keep

    def apply(self, x, adjoint=False):
        if adjoint:
            out = torch.zeros((self._n, x.shape[1]), dtype=x.dtype,
                              device=x.device)
            return out.index_copy_(0, self._keep, x)
        return x.index_select(0, self._keep)

    def cost(self, ncols=1):
        m, n = self.shape
        return 0, (m + n) * ncols * self._isz() + n * 4


class CropPad(Operator):
    """Centered zero-pad (forward) / crop (adjoint) between two volumes:
    shape (prod(out_shape), prod(in_shape))."""

    def __init__(self, in_shape, out_shape, dtype=torch.complex64,
                 name=None, device=None):
        super().__init__(name)
        self._in = tuple(int(s) for s in in_shape)
        self._out = tuple(int(s) for s in out_shape)
        if len(self._in) != len(self._out):
            raise ValueError("rank mismatch")
        for a, b in zip(self._in, self._out):
            if a > b:
                raise ValueError("in_shape must fit inside out_shape")
        self._dtype = as_dtype(dtype)
        self._record_device(device)

    @property
    def in_shape(self):
        return self._in

    @property
    def out_shape(self):
        return self._out

    @property
    def shape(self):
        return (int(np.prod(self._out)), int(np.prod(self._in)))

    @property
    def dtype(self):
        return self._dtype

    def apply(self, x, adjoint=False):
        K = x.shape[1]
        offs = [(o - i) // 2 for i, o in zip(self._in, self._out)]
        if adjoint:
            v = x.reshape(self._out + (K,))
            sl = tuple(slice(o, o + i) for i, o in zip(self._in, offs))
            return v[sl].reshape(-1, K)
        v = x.reshape(self._in + (K,))
        # F.pad lists (before, after) pairs from the last dim backwards
        pad = [0, 0]
        for a, b, o in reversed(list(zip(self._in, self._out, offs))):
            pad += [o, b - a - o]
        return nn.functional.pad(v, pad).reshape(-1, K)

    def cost(self, ncols=1):
        m, n = self.shape
        return 0, (m + n) * ncols * self._isz()

    def _describe(self):
        return (f"{self.name}{list(self._in)}->{list(self._out)} "
                f"<{self.shape[0]}x{self.shape[1]}>")


# ========================= combinators =================================


def _sum_costs(ops, ncols):
    f = b = 0
    for c in ops:
        cf, cb = c.cost(ncols)
        f += cf
        b += cb
    return f, b


def _result_dtype(ops):
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return dt


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

    @property
    def dtype(self):
        return _result_dtype((self.left, self.right))

    def apply(self, x, adjoint=False):
        if adjoint:
            return self.right.apply(self.left.apply(x, adjoint=True),
                                    adjoint=True)
        return self.left.apply(self.right.apply(x))

    def cost(self, ncols=1):
        return _sum_costs((self.left, self.right), ncols)


class Adjoint(Operator):
    """Conjugate-transpose wrapper (``A.H``). As in the reference,
    ``Adjoint(Adjoint(A))`` constructs nothing and is ``A`` itself (the
    child is never an Adjoint, so ``__init__`` does not run for it)."""

    def __new__(cls, A=None, name=None):
        if isinstance(A, Adjoint):
            return A.child
        return super().__new__(cls)

    def __init__(self, A, name=None):
        super().__init__(name)
        self.child = A

    @property
    def shape(self):
        m, n = self.child.shape
        return (n, m)

    @property
    def dtype(self):
        return self.child.dtype

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

    @property
    def dtype(self):
        return self.child.dtype

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

    def _describe(self):
        M, N = self.shape
        return f"{self.name}(c={self.c}) <{M}x{N}>"


class _Stack(Operator):
    """Shared surface of the block combinators: ``blocks`` (an
    ``nn.ModuleList``, so the blocks' buffers move and save with the
    tree), ``children()``, ``dtype``, ``cost()``."""

    def __init__(self, blocks, name=None):
        super().__init__(name)
        blocks = list(blocks)
        if not blocks:
            raise ValueError(f"{type(self).__name__} needs at least one "
                             "block")
        self._check(blocks)
        self.blocks = nn.ModuleList(blocks)

    def _check(self, blocks):
        pass

    def children(self):
        return tuple(self.blocks)

    @property
    def dtype(self):
        return _result_dtype(tuple(self.blocks))

    def cost(self, ncols=1):
        return _sum_costs(self.blocks, ncols)


def _split_apply(blocks, x, adjoint, by_rows):
    """Each block applied to its own slice of x's rows: the slice widths
    are the blocks' input sizes in the direction applied."""
    outs, off = [], 0
    for b in blocks:
        m, n = b.shape
        w = m if by_rows else n
        outs.append(b.apply(x[off:off + w], adjoint=adjoint))
        off += w
    return outs


def _sum(parts):
    y = parts[0]
    for t in parts[1:]:
        y = y + t
    return y


class BlockDiag(_Stack):
    """diag(A_1, ..., A_k): each block applies to its row/col slice. For
    equal blocks prefer ``KronI`` (one batched apply)."""

    @property
    def shape(self):
        return (sum(b.shape[0] for b in self.blocks),
                sum(b.shape[1] for b in self.blocks))

    def apply(self, x, adjoint=False):
        return torch.cat(_split_apply(self.blocks, x, adjoint,
                                      by_rows=adjoint), dim=0)


class VStack(_Stack):
    """[A_1; A_2; ...]: stacked outputs, shared input; the adjoint sums the
    per-block adjoints."""

    def _check(self, blocks):
        if any(b.shape[1] != blocks[0].shape[1] for b in blocks):
            raise ValueError("VStack blocks must share input width")

    @property
    def shape(self):
        return (sum(b.shape[0] for b in self.blocks),
                self.blocks[0].shape[1])

    def apply(self, x, adjoint=False):
        if adjoint:
            return _sum(_split_apply(self.blocks, x, True, by_rows=True))
        return torch.cat([b.apply(x) for b in self.blocks], dim=0)


class HStack(_Stack):
    """[A_1, A_2, ...]: split input, summed outputs."""

    def _check(self, blocks):
        if any(b.shape[0] != blocks[0].shape[0] for b in blocks):
            raise ValueError("HStack blocks must share output height")

    @property
    def shape(self):
        return (self.blocks[0].shape[0],
                sum(b.shape[1] for b in self.blocks))

    def apply(self, x, adjoint=False):
        if adjoint:
            return torch.cat([b.apply(x, adjoint=True)
                              for b in self.blocks], dim=0)
        return _sum(_split_apply(self.blocks, x, False, by_rows=False))


class Scale(Operator):
    """alpha * A for a scalar alpha; the adjoint scales by conj(alpha)."""

    def __init__(self, alpha, A, name=None):
        super().__init__(name)
        self.alpha = alpha.item() if hasattr(alpha, "item") else alpha
        self.child = A

    @property
    def shape(self):
        return self.child.shape

    @property
    def dtype(self):
        a = torch.complex64 if isinstance(self.alpha, complex) \
            else torch.float32
        return torch.promote_types(a, self.child.dtype)

    def apply(self, x, adjoint=False):
        a = self.alpha.conjugate() if adjoint else self.alpha
        return a * self.child.apply(x, adjoint=adjoint)

    def cost(self, ncols=1):
        return self.child.cost(ncols)
