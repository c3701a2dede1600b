"""Zero-aware doubled-grid FFTs for the Toeplitz normal operator (torch).

Counterpart of ``indigo_tpu/ops/toeplitz_fft.py``. A 2N-point FFT of an
N-support signal is two N-point FFTs (decimation in frequency):

    X[2m]   = F_N(x)[m]
    X[2m+1] = F_N(x * t)[m],   t[n] = exp(-i pi n / N)

and the inverse restricted to n < N is

    x[n] = 0.5 * (IF_N(X_even)[n] + conj(t)[n] * IF_N(X_odd)[n]).

Applied axis by axis, no transform ever touches the padding zeros. The
input occupies the corner [0, N) of each axis (circular convolution is
translation invariant, so the Toeplitz kernel is unchanged). The spectrum
is in natural (interleaved) frequency order: the raw ``toeplitz_kernel``
output. Plain ``torch.fft``; the reference has no Pallas kernel here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fft_pad2x", "ifft_crop2x"]


def _twiddle(n, ax, ndim, dtype, device):
    """exp(-i pi j / n) shaped to broadcast along axis ``ax``."""
    t = np.exp(-1j * np.pi * np.arange(n) / n)
    shape = [1] * ndim
    shape[ax] = n
    return torch.from_numpy(t).to(device=device, dtype=dtype).reshape(shape)


def fft_pad2x(x, axes):
    """FFT of x zero-padded 2x along ``axes`` (corner embedding), without
    materializing the zeros before each axis transform."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    for ax in axes:
        n = x.shape[ax]
        t = _twiddle(n, ax, x.dim(), x.dtype, x.device)
        even = torch.fft.fft(x, dim=ax)
        odd = torch.fft.fft(x * t, dim=ax)
        shape = list(x.shape)
        shape[ax] = 2 * n
        x = torch.stack([even, odd], dim=ax + 1).reshape(shape)
    return x


def ifft_crop2x(X, axes):
    """First N outputs (per axis) of the inverse FFT of a 2N spectrum: the
    crop is folded into the transform, halving the work per axis."""
    for ax in axes:
        n = X.shape[ax] // 2
        shape = list(X.shape)
        st = X.reshape(shape[:ax] + [n, 2] + shape[ax + 1:])
        even = st.select(ax + 1, 0)
        odd = st.select(ax + 1, 1)
        t = _twiddle(n, ax, even.dim(), X.dtype, X.device)
        X = 0.5 * (torch.fft.ifft(even, dim=ax)
                   + t.conj() * torch.fft.ifft(odd, dim=ax))
    return X
