"""Doubled-grid and centered DFTs as per-axis matrix products (torch).

Counterpart of ``indigo_tpu/ops/dft_fft.py``. The host matrix constructors are
numpy copies (held array-equal to the reference by the tests); the applies
are ``torch.einsum`` stages.

The Toeplitz normal operator needs FFT(pad_2x(x)) -> pointwise multiply ->
crop(IFFT(.)). A 2N-point DFT of an N-support signal is one (2N x N) matrix
product with the twiddles folded in (``dft_pad2x_mats``), its frequencies in
block (even|odd) order per axis; the inverse-with-crop is one (N x 2N)
product. The spectrum is permuted into the same block order once on the host
(``block_spectrum``), so no interleave pass ever runs.

Each stage contracts the axis right after the batch dim and appends the new
axis last, so nd stages cycle the axes back into their original order.

Precision: the products run in full float32. On CUDA the stages switch off
TF32 for matrix products (``torch.backends.cuda.matmul.allow_tf32``), which
would keep only ~3 decimal digits and break the 1e-5 operator-level bar.
The applies take the reference's ``precision`` argument (its TPU matmul
knob) and ignore it: the f32 stages run with TF32 off whatever is passed.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "dft_pad2x_mats", "block_perm", "block_spectrum",
    "fft_pad2x_block", "ifft_crop2x_block", "toeplitz_apply_block",
    "centered_pad_dft_mat", "dft_nd_apply", "tiled_idft_mats",
    "full_f32_matmul",
]


@lru_cache(maxsize=None)
def dft_pad2x_mats(n: int):
    """(Mf, Mi) numpy complex64 for the zero-padded 2x transform.

    Mf (2n, n): forward — rows [0:n] the plain N-point DFT (even output
    frequencies), rows [n:2n] the twiddled DFT (odd frequencies).
    Mi (n, 2n): inverse restricted to the first n outputs — columns [0:n]
    consume the even block, [n:2n] the odd block, with the conjugate
    twiddle folded into the rows and the 0.5/n normalization baked in.
    """
    j = np.arange(n)
    F = np.exp(-2j * np.pi * np.outer(j, j) / n)
    t = np.exp(-1j * np.pi * j / n)
    Mf = np.concatenate([F, F * t[None, :]], axis=0)
    Fi = np.exp(2j * np.pi * np.outer(j, j) / n) / n
    Mi = np.concatenate([0.5 * Fi, 0.5 * np.conj(t)[:, None] * Fi], axis=1)
    return Mf.astype(np.complex64), Mi.astype(np.complex64)


def block_perm(n2: int) -> np.ndarray:
    """Permutation mapping block-layout index -> true frequency index for an
    axis of (doubled) length n2: [0,2,4,...] then [1,3,5,...]."""
    assert n2 % 2 == 0
    return np.concatenate([np.arange(0, n2, 2), np.arange(1, n2, 2)])


def block_spectrum(Tf: np.ndarray) -> np.ndarray:
    """Permute a host spectrum on the doubled grid into the block (even|odd)
    layout produced by ``fft_pad2x_block``, on every axis (once, host-side)."""
    Tf = np.asarray(Tf)
    perms = [block_perm(s) for s in Tf.shape]
    return np.ascontiguousarray(Tf[np.ix_(*perms)])


@lru_cache(maxsize=None)
def centered_pad_dft_mat(n: int, g: int):
    """(g, n) complex64 matrix folding centered zero-pad + centered FFT.

    With o = (g-n)//2 the centered pad offset,

        M[k, j] = (-1)^(g/2) (-1)^k (-1)^(j+o) exp(-2i pi k (j+o) / g)

    Its exact conjugate transpose is the adjoint (crop . unnormalized
    inverse centered FFT).
    """
    assert g % 2 == 0 and n <= g
    o = (g - n) // 2
    k = np.arange(g)[:, None]
    j = np.arange(n)[None, :] + o
    M = np.exp(-2j * np.pi * k * j / g)
    M *= ((-1.0) ** (g // 2)) * ((-1.0) ** k) * ((-1.0) ** j)
    return M.astype(np.complex64)


def tiled_idft_mats(img_shape, grid_shape, tile):
    """Per-axis adjoint centered-DFT matrices in tiled form (N_d, nt_d, T_d).

    Host constructor kept for parity with the reference's tiled adjoint layout;
    the port's gridding scatters into the natural-order grid and applies
    the untiled adjoint matrices with :func:`dft_nd_apply`.
    """
    mats = []
    for n, g, t in zip(img_shape, grid_shape, tile):
        assert g % t == 0, (g, t)
        m = np.conj(centered_pad_dft_mat(n, g)).T
        mats.append(np.ascontiguousarray(m.reshape(n, g // t, t)))
    return mats


def full_f32_matmul():
    """Keep CUDA float32/complex64 matrix products in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False


@lru_cache(maxsize=64)
def _pad2x_tensors(n: int, device: torch.device):
    Mf, Mi = dft_pad2x_mats(n)
    return (torch.from_numpy(Mf).to(device), torch.from_numpy(Mi).to(device))


def _stage(x, M):
    """Contract axis 1 of x with M (m, l), appending the new axis last."""
    if x.is_cuda:
        full_f32_matmul()
    d = x.dim()
    ls = "abcdefgh"[:d]
    sub = ls[0] + "l" + ls[2:]
    out = ls[0] + ls[2:] + "m"
    return torch.einsum(f"{sub},ml->{out}", x, M)


def dft_nd_apply(x, mats, precision="highest"):
    """Apply per-axis matrices to x (K, *dims): mats[d] is (out_d, dims[d])
    complex64 on x's device; axes return to their original order."""
    for M in mats:
        x = _stage(x, M)
    return x


def fft_pad2x_block(x, precision="highest"):
    """FFT of x zero-padded 2x along all trailing (image) axes, frequencies
    in block (even|odd) layout per axis. x: (batch, *img) complex."""
    x = x.to(torch.complex64)
    for _ in range(x.dim() - 1):
        Mf, _ = _pad2x_tensors(int(x.shape[1]), x.device)
        x = _stage(x, Mf)
    return x


def ifft_crop2x_block(X, precision="highest"):
    """First N outputs (per axis) of the inverse FFT of a block-layout 2N
    spectrum. X: (batch, *2img) complex -> (batch, *img)."""
    for _ in range(X.dim() - 1):
        _, Mi = _pad2x_tensors(int(X.shape[1]) // 2, X.device)
        X = _stage(X, Mi)
    return X


def toeplitz_apply_block(Tfb, v, precision="highest"):
    """crop(IFFT(Tfb * FFT(pad_2x(v)))) with Tfb in block layout.

    v: (batch, *img) complex64 tensor; Tfb: (*2img) float32 tensor.
    """
    V = fft_pad2x_block(v)
    V = Tfb[None] * V
    return ifft_crop2x_block(V)
