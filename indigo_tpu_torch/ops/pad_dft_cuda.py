"""The adjoint centered pad-DFT on the card: a CUDA kernel and its plain
version.

    grid (K, g_0, .., g_{r-1}) -> image (K, n_0, .., n_{r-1}),
    per axis the conjugate transpose of ``dft_fft.centered_pad_dft_mat(n, g)``

``pad_idft_cuda`` launches ``csrc/pad_dft.cu`` on the current CUDA stream,
one launch per axis (the last axis first, each pass cropping its axis), and
counts them in ``pad_idft_cuda.launches``. Each axis is the unnormalised
inverse DFT of length g by K1's two-factor FFT (``dft_cuda.fft_factors``
and its table ``fft_table``, the device code in ``csrc/fft_reg.cuh``), its
input checkerboard an index shift of the outputs and its output sign the
parity of the output index, storing only the n kept outputs
(:func:`pad_idft_mirror` repeats the arithmetic in torch through
``dft_cuda.four_step``, in the kernel's index order, for the CPU tests).
CPU tensors run :func:`pad_idft_reference`, the plain version: the three
matrix products ``dft_nd_apply`` runs.

The kernel replaces no TPU kernel: the reference leaves this transform to
XLA's dense matrix products (``indigo_tpu/ops/dft_fft.py``,
``dft_nd_apply``). Its bound on the card is bytes: the grid read once and
the image written once (:func:`pad_idft_bytes`, 3.17 GB at 320^3 -> 256^3
and 8 coils). Its passes also write and read the volumes between them
(:func:`pad_idft_pass_bytes`, 9.2 GB there).

On the card the call goes through an autograd Function: the adjoint's
gradient is the forward centered pad-DFT, which runs as the plain matrix
products (no TPU kernel had a backward here).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .dft_cuda import _check, fft_factors, fft_positions, fft_table, four_step
from .dft_fft import centered_pad_dft_mat, dft_nd_apply

__all__ = ["pad_dft_serves", "pad_idft_reference", "pad_idft_mirror",
           "pad_idft_bytes", "pad_idft_pass_bytes", "pad_idft_cuda"]


def _planned(g: int) -> bool:
    try:
        fft_factors(g)
    except ValueError:
        return False
    return True


def pad_dft_serves(img_shape, grid_shape, device) -> bool:
    """True when the kernel serves an adjoint from ``grid_shape`` to
    ``img_shape`` on ``device``: a CUDA device, on every axis a g that
    ``fft_factors`` plans (a multiple of 8, q = g / p <= 32) and n <= g,
    and a grid of fewer than 2^31 points (the kernel's offsets within a
    volume are 32-bit)."""
    if torch.device(device).type != "cuda" or len(img_shape) != len(
            grid_shape) or not img_shape:
        return False
    if int(np.prod([int(g) for g in grid_shape])) >= 2**31:
        return False
    return all(1 <= n <= g and _planned(int(g))
               for n, g in zip(img_shape, grid_shape))


@lru_cache(maxsize=16)
def _mats(img_shape, grid_shape, device, adjoint):
    """Per-axis ``centered_pad_dft_mat(n, g)`` on ``device``, or their
    conjugate transposes."""
    mats = [centered_pad_dft_mat(n, g) for n, g in zip(img_shape, grid_shape)]
    if adjoint:
        mats = [np.ascontiguousarray(m.conj().T) for m in mats]
    return tuple(torch.from_numpy(m).to(device) for m in mats)


def pad_idft_reference(x, img_shape):
    """Plain torch version: x (K, *grid) complex64 -> (K, *img) by the
    adjoint matrices, as ``dft_nd_apply`` (three GEMMs on the card)."""
    grid = tuple(int(s) for s in x.shape[1:])
    return dft_nd_apply(x, _mats(tuple(img_shape), grid, x.device, True))


def _axis_mirror(x, n):
    """One pass along the last axis, as the kernel runs it: the inverse
    DFT of length g by ``four_step`` on the conjugates (K1's factors and
    f32 table, conjugated: stage 1 the p-point DFTs of the stride-q runs,
    times W_g^{-ab}; stage 2 the q-point DFTs over the runs, which the
    kernel at q 20 forms as 4 x 5 with the same table), output m at
    ``fft_positions`` row; kept j < n at m = j + shift (mod g), times
    (-1)^m."""
    g = int(x.shape[-1])
    Y = four_step(x.conj()).conj()
    m = (np.arange(n) + (g - n) // 2 + g // 2) % g
    sign = torch.from_numpy((-1.0) ** m)
    return Y[..., torch.from_numpy(fft_positions(g)[m])] * sign


def pad_idft_mirror(x, img_shape):
    """The kernel's arithmetic in torch (complex128): x (K, *grid) ->
    (K, *img), the last axis first, each axis by :func:`_axis_mirror`
    with the kernel's factors, table, sign and crop."""
    y = x.to(torch.complex128)
    r = len(img_shape)
    for d in reversed(range(r)):
        y = _axis_mirror(y.movedim(d + 1, -1), int(img_shape[d]))
        y = y.movedim(-1, d + 1)
    return y


def pad_idft_bytes(img_shape, grid_shape, K):
    """The transform's bytes: the grid read once and the image written
    once, complex64. The kernel's bound."""
    return (int(np.prod(grid_shape)) + int(np.prod(img_shape))) * K * 8


def pad_idft_pass_bytes(img_shape, grid_shape, K):
    """Bytes each of the kernel's passes reads and writes once, the last
    axis first, each cropping its axis: the passes' own floor, which
    counts the volumes between them too."""
    dims, out = [int(g) for g in grid_shape], []
    for d in reversed(range(len(dims))):
        before = int(np.prod(dims))
        dims[d] = int(img_shape[d])
        out.append((before + int(np.prod(dims))) * K * 8)
    return out


@lru_cache(maxsize=16)
def _table(g, device):
    return torch.from_numpy(fft_table(g)).to(device)


def _validate(x, img_shape):
    if not x.is_cuda:
        raise ValueError("pad_idft_cuda: x must lie on a CUDA device")
    if x.dtype != torch.complex64:
        raise TypeError("pad_idft_cuda: x must be complex64")
    if not x.is_contiguous():
        raise ValueError("pad_idft_cuda: x must be contiguous")
    grid = tuple(int(s) for s in x.shape[1:])
    if x.dim() < 2 or not pad_dft_serves(img_shape, grid, x.device):
        raise ValueError(f"pad_idft_cuda: no plan from grid {grid} to "
                         f"image {tuple(img_shape)}")


def _run(x, img_shape):
    """Enqueue one pass per axis, the last first, on the current stream;
    each allocates its cropped output and adds one to ``launches``."""
    from ._build import load_library

    lib = load_library()
    dims = [int(s) for s in x.shape]
    with torch.cuda.device(x.device):
        st = torch.cuda.current_stream().cuda_stream
        for d in reversed(range(1, len(dims))):
            g, n = dims[d], int(img_shape[d - 1])
            p, q = fft_factors(g)
            count = int(np.prod(dims[:d]))
            ncols = int(np.prod(dims[d + 1:]))
            dims[d] = n
            out = torch.empty(dims, dtype=torch.complex64, device=x.device)
            _check(lib, lib.indigo_pad_idft(
                x.data_ptr(), out.data_ptr(), _table(g, x.device).data_ptr(),
                p, q, int(d == len(dims) - 1), n, count, ncols, st),
                f"pad_idft_cuda axis {d - 1}")
            pad_idft_cuda.launches += 1
            x = out
    return x


class _PadIdftFn(torch.autograd.Function):
    """The adjoint pad-DFT, differentiable in x: ``launch(x, img_shape)``
    computes it; the backward applies the forward matrices (the adjoint's
    adjoint) to the cotangent and adds one to
    ``pad_idft_cuda.backward_calls``."""

    @staticmethod
    def forward(ctx, launch, x, img_shape):
        ctx.shapes = img_shape, tuple(int(s) for s in x.shape[1:])
        return launch(x, img_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pad_idft_cuda.backward_calls += 1
        return None, dft_nd_apply(g.contiguous(),
                                  _mats(*ctx.shapes, g.device, False)), None


def pad_idft_cuda(x, img_shape):
    """Adjoint centered pad-DFT: x (K, *grid) complex64 -> (K, *img).

    CUDA tensors launch the kernel, one launch per axis
    (``pad_idft_cuda.launches``), through an autograd Function whose
    backward applies the forward matrices (``pad_idft_cuda.backward_calls``
    counts them). x must be contiguous, and the shapes ones
    :func:`pad_dft_serves` takes; anything else raises. CPU tensors run the
    plain version."""
    img_shape = tuple(int(s) for s in img_shape)
    if x.device.type == "cpu":
        return pad_idft_reference(x, img_shape)
    _validate(x, img_shape)
    return _PadIdftFn.apply(_run, x, img_shape)


pad_idft_cuda.launches = 0
pad_idft_cuda.backward_calls = 0
