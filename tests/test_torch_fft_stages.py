"""The CUDA Toeplitz kernels' FFT factorisation, checked on the CPU.

``ops.dft_cuda.four_step`` applies the kernels' n-point transform with
their factors (``fft_factors``) and their f32 twiddle table (``fft_table``)
in their index order (``fft_positions``). Around it, the zero-aware doubling
of each axis (even = F x, odd = F(t x); inverse with crop
(IF X_even + conj(t) IF X_odd) / 2n) must reproduce the reference's
``dft_pad2x_mats`` and ``torch.fft`` on every axis length the kernels meet,
to 1e-6 (the table is rounded to f32, the arithmetic is complex128).
``ops.dft_cuda.plane_pass`` runs the plane kernel's split of the y
transform around the x round trip; with float64 twiddles it is the exact
operator to 1e-10.
"""
import numpy as np
import pytest
import torch

from indigo_tpu.ops.dft_fft import dft_pad2x_mats as ref_pad2x_mats
from indigo_tpu_torch.ops.dft_cuda import (
    fft_factors, fft_positions, fft_table, four_step, plane_pass)
from indigo_tpu_torch.ops.dft_fft import block_perm, toeplitz_apply_block
from indigo_tpu_torch.utils import rand64c, rel_err

NS = [8, 16, 24, 40, 136, 248, 256]
TOL = 1e-6


def pad2x(x):
    """(.., n) -> (.., 2n) block (even|odd) spectrum, through four_step."""
    n = x.shape[-1]
    t = torch.from_numpy(fft_table(n)[:n]).to(torch.complex128)
    pos = torch.from_numpy(fft_positions(n))
    even = four_step(x)[..., pos]
    odd = four_step(x.to(torch.complex128) * t)[..., pos]
    return torch.cat([even, odd], dim=-1)


def crop2x(X):
    """(.., 2n) block spectrum -> (.., n): inverse with crop."""
    n = X.shape[-1] // 2
    t = torch.from_numpy(fft_table(n)[:n]).to(torch.complex128)
    pos = torch.from_numpy(fft_positions(n))
    halves = []
    for h in (X[..., :n], X[..., n:]):
        buf = torch.empty(h.shape, dtype=torch.complex128)
        buf[..., pos] = h.to(torch.complex128)
        halves.append(four_step(buf, inverse=True))
    return (halves[0] + t.conj() * halves[1]) * (0.5 / n)


@pytest.mark.parametrize("n", NS)
def test_factors_and_table(n):
    p, q = fft_factors(n)
    assert p * q == n and p in (8, 16) and q <= 32
    assert p == 16 or n % 16
    tab = fft_table(n)
    assert tab.dtype == np.complex64 and tab.shape == (2 * n,)
    exact = np.exp(-1j * np.pi * np.arange(2 * n, dtype=np.float64) / n)
    assert np.abs(tab - exact).max() < 1e-7
    assert sorted(fft_positions(n)) == list(range(n))


@pytest.mark.parametrize("n", NS)
def test_four_step_is_the_dft(n):
    x = torch.from_numpy(rand64c(5, n, rng=n))
    pos = torch.from_numpy(fft_positions(n))
    X = torch.fft.fft(x.to(torch.complex128))
    assert rel_err(four_step(x)[..., pos], X) < TOL
    buf = torch.empty_like(X)
    buf[..., pos] = X
    assert rel_err(four_step(buf, inverse=True), n * x) < TOL


@pytest.mark.parametrize("n", NS)
def test_pad2x_matches_reference_mats_and_torch_fft(n):
    x = torch.from_numpy(rand64c(4, n, rng=n + 1))
    Mf = torch.from_numpy(np.asarray(ref_pad2x_mats(n)[0])).to(
        torch.complex128)
    X = pad2x(x)
    assert rel_err(X, x.to(torch.complex128) @ Mf.T) < TOL
    full = torch.fft.fft(x.to(torch.complex128), n=2 * n)
    assert rel_err(X, torch.cat([full[..., 0::2], full[..., 1::2]], -1)) < TOL


@pytest.mark.parametrize("n", NS)
def test_crop2x_matches_reference_mats_and_torch_fft(n):
    X = torch.from_numpy(rand64c(4, 2 * n, rng=n + 2))
    Mi = torch.from_numpy(np.asarray(ref_pad2x_mats(n)[1])).to(
        torch.complex128)
    x = crop2x(X)
    assert rel_err(x, X.to(torch.complex128) @ Mi.T) < TOL
    inter = torch.empty((4, 2 * n), dtype=torch.complex128)
    inter[..., 0::2], inter[..., 1::2] = X[..., :n], X[..., n:]
    assert rel_err(x, torch.fft.ifft(inter)[..., :n]) < TOL


def test_round_trip_matches_plain_toeplitz_apply():
    """The doubling around four_step, axis by axis, is the plain K2."""
    from indigo_tpu_torch.ops.dft_cuda import (
        kernel_spectrum, toeplitz_apply_reference)

    rng = np.random.default_rng(3)
    shape = (8, 24, 16)
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    T = torch.from_numpy(kernel_spectrum(Tf))
    u = torch.from_numpy(rand64c(2, *shape, rng=rng))
    U = u.to(torch.complex128)
    for ax in (1, 2, 3):
        U = pad2x(U.movedim(ax, -1)).movedim(-1, ax)
    U = U * T.to(torch.float64)
    for ax in (1, 2, 3):
        U = crop2x(U.movedim(ax, -1)).movedim(-1, ax)
    assert rel_err(U, toeplitz_apply_reference(T, u)) < 1e-5


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 40, 32), (8, 256, 16),
                                   (32, 64, 256)])
def test_plane_pass_between_the_z_passes_is_the_round_trip(shape):
    """z forward, the plane pass, z inverse: with float64 twiddles the
    complex128 operator crop(IFFT(Tf FFT(pad_2x u))) to 1e-10; with the
    kernels' f32 tables, ``toeplitz_apply_block`` (complex64) to 1e-5.
    (24, 40, 32) takes the direct-sum q-point stages on y (q 5)."""
    n1, n2, n3 = shape
    rng = np.random.default_rng(n1 * n2 + n3)
    Tf = torch.from_numpy(rng.standard_normal(tuple(2 * s for s in shape)))
    u = torch.from_numpy(rand64c(2, *shape, rng=rng)).to(torch.complex128)
    full = torch.fft.fft(u, n=2 * n1, dim=1)
    t1 = torch.cat([full[:, 0::2], full[:, 1::2]], dim=1)

    def z_crop(X):
        inter = torch.empty((2, 2 * n1, n2, n3), dtype=torch.complex128)
        inter[:, 0::2], inter[:, 1::2] = X[:, :n1], X[:, n1:]
        return torch.fft.ifft(inter, dim=1)[:, :n1]

    back = [torch.from_numpy(np.argsort(block_perm(2 * s))) for s in shape]
    Tn = Tf[back[0]][:, back[1]][:, :, back[2]]
    exact = torch.fft.ifftn(
        Tn * torch.fft.fftn(u, s=tuple(2 * s for s in shape), dim=(1, 2, 3)),
        dim=(1, 2, 3))[:, :n1, :n2, :n3]
    assert rel_err(z_crop(plane_pass(t1, Tf, exact=True)), exact) < 1e-10
    plain = toeplitz_apply_block(Tf.float(), u.to(torch.complex64))
    assert rel_err(z_crop(plane_pass(t1, Tf)), plain) < 1e-5


def test_three_passes_per_call_and_their_bytes():
    """K1 and K2 launch three kernels a call (z forward, the plane pass, z
    inverse) and count their plane-pass calls; the passes' bytes hold no
    t2: the plane pass reads and writes t1 once (4 units per volume) and
    reads the f32 spectrum (4 units)."""
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, toeplitz_apply_cuda)
    from indigo_tpu_torch.profiling import pass_bytes

    assert LAUNCHES_PER_CALL == 3
    for fn in (sense_normal_cuda, toeplitz_apply_cuda):
        assert isinstance(fn.plane_calls, int) and fn.plane_calls >= 0
    V, unit = 256 ** 3, 8 * 256 ** 3
    assert pass_bytes((256,) * 3, 1, 4) == [unit * 13, unit * 16 + 4 * unit,
                                            unit * 13]
    assert pass_bytes((256,) * 3, 8, 0) == [unit * 24, unit * 32 + 32 * V,
                                            unit * 24]
