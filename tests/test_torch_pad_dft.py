"""The adjoint pad-DFT kernel's arithmetic, checked on the CPU.

``ops.pad_dft_cuda.pad_idft_mirror`` repeats ``csrc/pad_dft.cu`` in torch
(complex128): per axis, the last first, K1's two-factor FFT
(``dft_cuda.four_step`` with the factors of ``fft_factors`` and the f32
table ``fft_table``) in the inverse direction, the sign (-1)^m1 and the
crop by index. It must equal the conjugate-transposed
``centered_pad_dft_mat`` products (``dft_nd_apply``, complex64) to the
operator bar 1e-5 on every kind of factor plan (q 8, 16 and 20, and the
direct sums of other q with p 16 and 8), on the last axis and on earlier
ones, at odd and even crop offsets, in 1, 2 and 3 dimensions, at K 1 and
8.
"""
import numpy as np
import pytest
import torch

from indigo_tpu_torch.ops.dft_fft import centered_pad_dft_mat, dft_nd_apply
from indigo_tpu_torch.ops.pad_dft_cuda import (
    _PadIdftFn, pad_dft_serves, pad_idft_bytes, pad_idft_cuda,
    pad_idft_mirror, pad_idft_pass_bytes, pad_idft_reference)
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 1e-5

# (img, grid, K): every kind of factor plan (q 16, 20 and 8 in the
# kernel's registers: g 256, 320, 128; direct sums: p 16 with q 1, 2, 4,
# 5, 10, 32 at g 16, 32, 64, 80, 160, 512 and p 8 with q 3, 5 at g 24,
# 40), 320 -> 256 on the last axis and on the first, crop offsets
# (g - n) // 2 odd and even, odd n
CASES = [
    ((256,), (320,), 8),
    ((12, 16, 256), (16, 24, 320), 8),
    ((256, 6, 10), (320, 16, 24), 1),
    ((29, 51), (40, 64), 1),
    ((100, 128), (128, 160), 8),
    ((25, 7, 200), (32, 16, 256), 1),
    ((64, 60, 70), (80, 64, 80), 1),
    ((13, 11, 301), (16, 24, 512), 8),
]


def _adjoint(x, img):
    mats = [torch.from_numpy(np.ascontiguousarray(
        centered_pad_dft_mat(n, g).conj().T))
        for n, g in zip(img, x.shape[1:])]
    return dft_nd_apply(x, mats)


@pytest.mark.parametrize("img,grid,K", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_mirror_matches_the_adjoint_matrices(img, grid, K):
    x = torch.from_numpy(rand64c(K, *grid, rng=np.random.default_rng(5)))
    got = pad_idft_mirror(x, img)
    assert got.shape == (K,) + img
    assert rel_err(got, _adjoint(x, img).to(torch.complex128)) < TOL


def test_factor_plans():
    """The grid lengths the kernel plans are K1's factor plans, with the
    second factor up to 32 (the main path's g 320 = 16 x 20)."""
    planned = [g for g in range(2, 700, 2)
               if pad_dft_serves((1,), (g,), "cuda")]
    assert planned == sorted([8 * k for k in range(1, 33, 2)]
                             + list(range(16, 513, 16)))
    assert not pad_dft_serves((1,), (528,), "cuda")


def test_predicate_takes_the_card_and_planned_shapes_only():
    assert pad_dft_serves((256,) * 3, (320,) * 3, "cuda")
    assert pad_dft_serves((29, 51), (40, 64), torch.device("cuda", 1))
    assert not pad_dft_serves((256,) * 3, (320,) * 3, "cpu")
    assert not pad_dft_serves((16,) * 3, (20,) * 3, "cuda")     # g 20
    assert not pad_dft_serves((48, 48), (64, 40), "cuda")       # n > g
    assert not pad_dft_serves((16, 16), (20, 20, 20), "cuda")   # rank
    assert not pad_dft_serves((256,) * 4, (320,) * 4, "cuda")   # 2^31


def test_cpu_tensor_runs_the_plain_version():
    x = torch.from_numpy(rand64c(2, 20, 40, rng=np.random.default_rng(6)))
    before = pad_idft_cuda.launches
    out = pad_idft_cuda(x, (13, 31))
    assert torch.equal(out, _adjoint(x, (13, 31)))
    assert torch.equal(out, pad_idft_reference(x, (13, 31)))
    assert pad_idft_cuda.launches == before


def test_bytes_floor_at_the_main_path():
    # the transform: 320^3 read and 256^3 written per coil
    assert pad_idft_bytes((256,) * 3, (320,) * 3, 8) == 8 * 8 * (
        320**3 + 256**3)
    # the passes: 320^3 -> 320^2 256 -> 320 256^2 -> 256^3, each read and
    # written
    assert pad_idft_pass_bytes((256,) * 3, (320,) * 3, 8) == [
        8 * 8 * (a + b) for a, b in ((320**3, 320**2 * 256),
                                     (320**2 * 256, 320 * 256**2),
                                     (320 * 256**2, 256**3))]


def test_gradient_is_the_forward_pad_dft():
    """The Function's backward (the forward matrices on the cotangent)
    against autograd through the plain version."""
    rng = np.random.default_rng(7)
    img, grid = (13, 31), (20, 40)
    x0 = torch.from_numpy(rand64c(2, *grid, rng=rng))
    c = torch.from_numpy(rand64c(2, *img, rng=rng))
    grads = []
    for f in (lambda x: _PadIdftFn.apply(pad_idft_reference, x, img),
              lambda x: pad_idft_reference(x, img)):
        x = x0.clone().requires_grad_(True)
        torch.sum(c.conj() * f(x)).real.backward()
        grads.append(x.grad)
    assert rel_err(grads[0], grads[1]) < TOL
