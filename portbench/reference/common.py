"""Plain NUFFT SENSE pieces in PyTorch, written from the formulas alone.

The benchmark's yardstick: it imports torch, numpy and math only, and
nothing of the program under test. Every array the program derives (the
Kaiser-Bessel gridding weights, the deapodization, the density
compensation, the Toeplitz spectrum, the default lamda) is worked out here
again from the trajectory and the coil maps.

Conventions (those of the configurations' source):
  * trajectories are (M, d) in cycles/pixel, in [-0.5, 0.5);
  * an image of N pixels per axis is centred at pixel N/2, and the
    forward model is s_i = sum_j x_j exp(-2 pi i k_i . (j - N/2));
  * the oversampled grid has G = 2 round(N os / 2) nodes per axis; a
    sample at k is interpolated from the nodes q around (k + 1/2) G, with
    periodic wrap, by a Kaiser-Bessel kernel of ``width`` nodes and
    Beatty's beta; node q holds the frequency (q - G/2) / G;
  * the deapodization is 1 / FT(KB) per axis, the transform taken by the
    2001-point trapezoid rule over the kernel's support.

Every discrete Fourier transform is a dense matrix product over one axis,
computed as one real GEMM on the interleaved real and imaginary parts. So
the precision of the products is the precision this module is asked for:
``precision="float64"`` is the yardstick, ``"float32"`` the configuration's
own precision with TF32 off, and ``"tf32"`` the control a step below it
(float32 with every GEMM operand rounded to TF32, and TF32 allowed).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")


def real_dtype(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def complex_dtype(precision):
    return (torch.complex128 if precision == "float64"
            else torch.complex64)


@contextlib.contextmanager
def matmul_precision(precision):
    """TF32 products allowed for "tf32" and forbidden otherwise, restored
    on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x):
    """float32 tensor rounded to TF32 (10 mantissa bits), to nearest even:
    what a TF32 tensor core takes of each operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def grid_size(n, oversamp):
    return int(2 * round(n * oversamp / 2))


def beatty_beta(width, oversamp):
    """Beatty, Nishimura and Pauly (2005), eq. 5."""
    return math.pi * math.sqrt(
        (width / oversamp) ** 2 * (oversamp - 0.5) ** 2 - 0.8)


def kaiser_bessel(t, width, beta):
    x = torch.clamp(1.0 - (2.0 * t / width) ** 2, min=0.0)
    return torch.special.i0(beta * torch.sqrt(x)) / float(np.i0(beta))


def deapod_1d(n, g, width, beta):
    """1 / FT(KB) at the n image offsets (j - n/2) / g, float64 numpy."""
    t = np.linspace(-width / 2.0, width / 2.0, 2001)
    x = 1.0 - (2.0 * t / width) ** 2
    kbv = np.i0(beta * np.sqrt(np.clip(x, 0.0, None))) / np.i0(beta)
    off = (np.arange(n) - n // 2) / float(g)
    a = np.trapezoid(kbv[None, :] * np.cos(2 * np.pi * t[None, :]
                                           * off[:, None]), t, axis=1)
    return 1.0 / a


def outer(vectors):
    out = np.ones(())
    for v in vectors:
        out = np.multiply.outer(out, v)
    return out


def kb_taps(traj, grid, width, beta, dtype):
    """Gridding weights: (idx, wts), each (M, width**d); idx are flat
    row-major node indices of ``grid``. traj is a float64 tensor."""
    M, d = traj.shape
    idx = torch.zeros((M, 1), dtype=torch.int64, device=traj.device)
    wts = torch.ones((M, 1), dtype=torch.float64, device=traj.device)
    offs = torch.arange(width, device=traj.device)
    for ax in range(d):
        c = (traj[:, ax] + 0.5) * grid[ax]
        base = torch.ceil(c - width / 2.0).to(torch.int64)
        nodes = base[:, None] + offs[None, :]
        w_ax = kaiser_bessel(c[:, None] - nodes, width, beta)
        nodes = torch.remainder(nodes, grid[ax])
        idx = (idx[:, :, None] * grid[ax] + nodes[:, None, :]).reshape(M, -1)
        wts = (wts[:, :, None] * w_ax[:, None, :]).reshape(M, -1)
    return idx, wts.to(dtype)


def gather(grid_vals, idx, wts):
    """Interpolate: (..., prod(grid)) -> (..., M)."""
    g = grid_vals[..., idx.reshape(-1)].reshape(grid_vals.shape[:-1]
                                                + idx.shape)
    return torch.sum(g * wts, dim=-1)


def scatter(vals, idx, wts, n_grid):
    """Adjoint of ``gather`` for one vector: (M,) -> (n_grid,)."""
    out = torch.zeros((n_grid, 2), dtype=wts.dtype, device=vals.device)
    src = torch.view_as_real((vals[:, None] * wts).reshape(-1))
    out.index_add_(0, idx.reshape(-1), src)
    return torch.view_as_complex(out)


def centred_dft(n, g, precision, device, adjoint=False):
    """The (g, n) matrix of the centred DFT of an n-pixel axis padded to g
    nodes: exp(-2 pi i (q - g/2)(j - n/2) / g); with ``adjoint``, its
    conjugate transpose (n, g)."""
    q = np.arange(g)[:, None] - g // 2
    j = np.arange(n)[None, :] - n // 2
    m = np.mod(q * j, g)
    F = np.exp(-2j * np.pi * m / g)
    return dft_operand(F.conj().T if adjoint else F, precision, device)


def padded_dft(n, precision, device, inverse=False):
    """The (2n, n) DFT of a signal in the corner [0, n) of 2n points; with
    ``inverse``, the first n outputs of the normalised inverse DFT of 2n
    points, an (n, 2n) matrix."""
    f = np.arange(2 * n)[:, None]
    j = np.arange(n)[None, :]
    F = np.exp(-2j * np.pi * np.mod(f * j, 2 * n) / (2 * n))
    return dft_operand(F.conj().T / (2 * n) if inverse else F, precision,
                       device)


def shifted_dft(n, precision, device):
    """The (n, n) DFT of an n-point signal centred at n/2:
    exp(-2 pi i f (j - n/2) / n)."""
    f = np.arange(n)[:, None]
    j = np.arange(n)[None, :] - n // 2
    return dft_operand(np.exp(-2j * np.pi * np.mod(f * j, n) / n),
                       precision, device)


def dft_operand(F, precision, device):
    """A complex (m, n) matrix as the real (2n, 2m) matrix R with
    interleaved(x) @ R = interleaved(x @ F.T)."""
    m, n = F.shape
    R = np.empty((2 * n, 2 * m))
    R[0::2, 0::2] = F.real.T
    R[0::2, 1::2] = F.imag.T
    R[1::2, 0::2] = -F.imag.T
    R[1::2, 1::2] = F.real.T
    R = torch.from_numpy(R).to(device=device, dtype=real_dtype(precision))
    return tf32_round(R) if precision == "tf32" else R


def apply_axis(x, R, axis, precision):
    """The matrix that R stands for applied along ``axis`` of complex x."""
    x = torch.movedim(x, axis, -1)
    shape = x.shape
    xi = torch.view_as_real(x.contiguous()).reshape(-1, 2 * shape[-1])
    if precision == "tf32":
        xi = tf32_round(xi)
    y = xi @ R
    y = torch.view_as_complex(y.reshape(-1, R.shape[1] // 2, 2))
    return torch.movedim(y.reshape(shape[:-1] + (R.shape[1] // 2,)), -1,
                         axis)


def cg(normal, b, lamda, iters, tol=0.0):
    """Conjugate gradients on (normal + lamda I) x = b from x = 0, with the
    complex inner products' real parts. With tol > 0 the state freezes once
    ||r|| <= tol ||b||; ``iters`` steps are taken in any case."""
    def dot(a, c):
        return torch.sum((a.conj() * c).real)

    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = dot(r, r)
    bnorm = torch.sqrt(rs)
    done = bool(tol > 0 and bnorm <= tol * bnorm)
    for _ in range(iters):
        if done:
            break
        Ap = normal(p) + lamda * p
        alpha = rs / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rsn = dot(r, r)
        p = r + (rsn / rs) * p
        rs = rsn
        done = bool(tol > 0 and torch.sqrt(rs) <= tol * bnorm)
    return x


def compare(image, ref):
    """(relative l2 gap, largest gap over the largest reference value)."""
    a = torch.tensor(np.asarray(image)).to(ref.device, torch.complex128)
    r = ref.to(torch.complex128).reshape(a.shape)
    d = a - r
    return (float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r)),
            float(d.abs().max() / r.abs().max()))


class SenseNufft:
    """A = G F Z D S for every coil: maps S, deapodization D, the centred
    DFT of the zero-padded image F Z, Kaiser-Bessel interpolation G.

    traj (M, d) and maps (nc, *N) are host arrays or tensors; everything
    is computed in ``precision`` on ``device``."""

    def __init__(self, traj, maps, oversamp, width, precision, device):
        self.precision = precision
        self.rdt, self.cdt = real_dtype(precision), complex_dtype(precision)
        self.device = torch.device(device)
        self.traj = torch.as_tensor(np.asarray(traj), dtype=torch.float64,
                                    device=self.device)
        self.maps = torch.as_tensor(maps).to(self.device, self.cdt)
        self.img = tuple(self.maps.shape[1:])
        self.oversamp, self.width = oversamp, width
        self.grid = tuple(grid_size(n, oversamp) for n in self.img)
        self.beta = beatty_beta(width, oversamp)
        self.idx, self.wts = kb_taps(self.traj, self.grid, width, self.beta,
                                     self.rdt)
        self.deapod = torch.from_numpy(outer(
            [deapod_1d(n, g, width, self.beta)
             for n, g in zip(self.img, self.grid)])).to(self.device, self.rdt)
        self.F = [centred_dft(n, g, precision, self.device)
                  for n, g in zip(self.img, self.grid)]
        self.FH = [centred_dft(n, g, precision, self.device, adjoint=True)
                   for n, g in zip(self.img, self.grid)]

    def _axes(self, x, mats, first):
        for k, R in enumerate(mats):
            x = apply_axis(x, R, first + k, self.precision)
        return x

    def forward(self, x, coils=None):
        """image (*N) -> k-space (nc, M)."""
        coils = range(self.maps.shape[0]) if coils is None else coils
        x = torch.as_tensor(x).to(self.device, self.cdt).reshape(self.img)
        out = []
        for c in coils:
            g = self._axes(self.deapod * self.maps[c] * x, self.F, 0)
            out.append(gather(g.reshape(-1), self.idx, self.wts))
        return torch.stack(out)

    def adjoint(self, y):
        """k-space (nc, M) -> image (*N)."""
        n_grid = int(np.prod(self.grid))
        out = torch.zeros(self.img, dtype=self.cdt, device=self.device)
        for c in range(y.shape[0]):
            g = scatter(y[c], self.idx, self.wts, n_grid).reshape(self.grid)
            out += self.maps[c].conj() * self._axes(g, self.FH, 0)
        return self.deapod * out
