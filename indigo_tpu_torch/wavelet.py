"""Orthogonal discrete wavelet transform as a structured operator.

Counterpart of ``indigo_tpu/wavelet.py``, used by the l1-wavelet
compressed-sensing recipe (FISTA on a Cartesian SENSE operator):

  * per-axis, per-level analysis matrices are built on the host (numpy)
    and held as float32 buffers; each is applied as one matrix product
    along its axis, in full f32 (TF32 off);
  * periodic (circular) boundary, orthonormal filters => the adjoint is the
    exact inverse, so ``W.H * W == Eye`` to f32 precision.

Coefficient layout is the standard in-place one: after each level the
leading half of each transformed axis holds the approximation.
"""
from __future__ import annotations

import numpy as np
import torch

from .operators import Operator
from .ops.dft_fft import full_f32_matmul
from .utils import as_dtype, as_tensor, default_device

__all__ = ["DWT", "WAVELETS"]

_SQRT2 = np.sqrt(2.0)

# Orthonormal analysis low-pass filters (Daubechies family).
WAVELETS = {
    "haar": np.array([1.0, 1.0]) / _SQRT2,
    "db2": np.array([0.48296291314469025, 0.836516303737469,
                     0.22414386804185735, -0.12940952255092145]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def _analysis_matrix(L, h):
    """One-level periodic orthogonal analysis matrix (L, L), rows =
    [approx (L/2) ; detail (L/2)]."""
    T = len(h)
    g = np.array([(-1) ** t * h[T - 1 - t] for t in range(T)])
    W = np.zeros((L, L), dtype=np.float32)
    for k in range(L // 2):
        for t in range(T):
            W[k, (2 * k + t) % L] += h[t]
            W[L // 2 + k, (2 * k + t) % L] += g[t]
    return W


def _axis_mul(v, W, axis):
    """Contract ``axis`` of v with the real square matrix W (out, in).

    v is read as (pre, L, post) around the axis and the product is the
    batched W @ v[p], so no axis is moved and nothing is copied but a
    non-contiguous v. A complex v goes through its (re, im) view, which
    doubles ``post`` and keeps the product a real f32 one; only its last
    axis (``post`` would be the bare pair) is one complex product."""
    if v.is_cuda:
        full_f32_matmul()
    v = v.contiguous()
    L = v.shape[axis]
    if axis == v.dim() - 1:
        return torch.matmul(v.reshape(-1, L), W.T.to(v.dtype)).reshape(
            v.shape)
    r = torch.view_as_real(v) if v.is_complex() else v
    pre = int(np.prod(v.shape[:axis]))
    r = torch.matmul(W.to(r.dtype), r.reshape(pre, L, -1)).reshape(r.shape)
    return torch.view_as_complex(r) if v.is_complex() else r


class DWT(Operator):
    """Multi-level orthogonal DWT over a volume of any rank; columns are
    the batch.

    shape (N, N) with N = prod(vol_shape); forward = analysis,
    adjoint = synthesis (exact inverse). Buffers ``w{level}_{axis}`` hold
    the (s >> level)-point analysis matrix of each level and axis, on
    ``device`` (default the card, and an error where there is none, as
    every leaf; ``utils.as_tensor``).
    """

    def __init__(self, vol_shape, wavelet="db4", levels=None,
                 dtype=torch.complex64, name=None, device=None):
        super().__init__(name)
        device = default_device(device)
        self._vol = tuple(int(s) for s in vol_shape)
        self._wavelet = wavelet
        h = WAVELETS[wavelet]
        max_lv = min(int(np.log2(s)) for s in self._vol)
        self._levels = (int(levels) if levels is not None
                        else max(1, max_lv - 2))
        for s in self._vol:
            if s % (1 << self._levels):
                raise ValueError(
                    f"axis {s} not divisible by 2^{self._levels}")
            if (s >> (self._levels - 1)) < len(h):
                raise ValueError("too many levels for filter length")
        for lv in range(self._levels):
            for ax, s in enumerate(self._vol):
                self.register_buffer(
                    f"w{lv}_{ax}",
                    as_tensor(_analysis_matrix(s >> lv, h), device))
        self._dtype = as_dtype(dtype)

    @property
    def vol_shape(self):
        return self._vol

    @property
    def levels(self):
        return self._levels

    @property
    def shape(self):
        n = int(np.prod(self._vol))
        return (n, n)

    @property
    def dtype(self):
        return self._dtype

    def apply(self, x, adjoint=False):
        K = x.shape[1]
        nd = len(self._vol)
        v = x.T.reshape((K,) + self._vol)   # K in front: a view for K = 1
        own = False  # v is still (a view of) the caller's x
        levels = range(self._levels)
        for lv in (reversed(levels) if adjoint else levels):
            sl = (slice(None),) + tuple(slice(0, s >> lv) for s in self._vol)
            sub = v[sl]
            axes = range(nd)
            for ax in (reversed(axes) if adjoint else axes):
                W = getattr(self, f"w{lv}_{ax}")
                sub = _axis_mul(sub, W.T if adjoint else W, ax + 1)
            if lv == 0:
                v, own = sub, True          # level 0 spans the whole volume
            else:
                if not own:
                    v, own = v.clone(), True
                v[sl] = sub
        return v.reshape(K, -1).T

    def cost(self, ncols=1):
        n, K = self.shape[0], ncols
        return 16 * n * K, 4 * n * K * self._isz()

    def _describe(self):
        return (f"{self.name}({self._wavelet}, L={self._levels})"
                f"{list(self._vol)} <{self.shape[0]}x{self.shape[1]}>")
