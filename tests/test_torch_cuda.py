"""CUDA kernel tests: they need an NVIDIA GPU with nvcc and skip elsewhere.

This file imports neither jax nor indigo_tpu, so it runs on a GPU machine
without jax, where tests/conftest.py (which imports jax) must be skipped:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -rs

Tolerance 1e-4 against the plain torch version: the kernels' FFT stages
round in f32 in another order than the plain matmul DFT on cuBLAS. The
Toeplitz shapes cover every factor plan of the kernels: 16 x 16 (256),
16 x 8 (128), 16 x q direct (16, 48, ...) and 8 x q direct (8, 24, 40, 136),
on the z axis and on each axis of the plane pass (y, x); 256^3 is the main
path's (K1 at 4 coils, K2 at B 8).
"""
import numpy as np
import pytest
import torch

from indigo_tpu_torch.ops.dft_cuda import (
    LAUNCHES_PER_CALL, kernel_spectrum, sense_normal_cuda,
    sense_normal_reference)
from indigo_tpu_torch.utils import rand64c, rel_err

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc to build the kernel")
    return torch.device("cuda")


def _inputs(rng, shape, S, nc, dev):
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    return (torch.from_numpy(kernel_spectrum(Tf)).to(dev),
            torch.from_numpy(rand64c(nc, *shape, rng=rng)).to(dev),
            torch.from_numpy(rand64c(S, *shape, rng=rng)).to(dev))


@pytest.mark.parametrize("shape,S,nc", [((8, 8, 8), 1, 2),
                                        ((8, 16, 24), 2, 3),
                                        ((16, 136, 8), 1, 2),
                                        ((24, 8, 136), 2, 1),
                                        ((24, 136, 40), 1, 3),
                                        ((8, 256, 16), 2, 2),
                                        ((256, 16, 128), 1, 2),
                                        ((256, 256, 256), 1, 4)])
def test_kernel_matches_plain(cuda, shape, S, nc):
    T, m, x = _inputs(np.random.default_rng(1), shape, S, nc, cuda)
    before = sense_normal_cuda.launches
    planes = sense_normal_cuda.plane_calls
    out = sense_normal_cuda(T, m, x)
    torch.cuda.synchronize()
    assert sense_normal_cuda.launches == before + LAUNCHES_PER_CALL
    assert sense_normal_cuda.plane_calls == planes + 1
    assert rel_err(out, sense_normal_reference(T, m, x)) < 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda):
    T, m, x = _inputs(np.random.default_rng(2), (8, 8, 8), 1, 2, cuda)
    with pytest.raises(TypeError):
        sense_normal_cuda(T, m.to(torch.complex128), x)
    with pytest.raises(ValueError):
        sense_normal_cuda(T, m, x.transpose(1, 3))
    T2, m2, x2 = _inputs(np.random.default_rng(2), (12, 8, 8), 1, 2, cuda)
    with pytest.raises(ValueError):
        sense_normal_cuda(T2, m2, x2)


def test_recon_kernel_path_matches_cpu_plain_path(cuda):
    from indigo_tpu_torch.models import SenseRecon

    rng = np.random.default_rng(3)
    n, nc = 32, 4
    dirs = rng.standard_normal((256, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(32) - 16) / 32
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + rand64c(nc, n, n, n, rng=rng) * 0.1).astype(np.complex64)
    kw = dict(oversamp=1.25, width=4, iters=8, coil_chunk=2)
    gpu = SenseRecon(traj, maps, device="cuda", **kw)
    cpu = SenseRecon(traj, maps, device="cpu", **kw)
    assert gpu.layout == "kernel" and cpu.layout == "block"
    y = rand64c(nc * len(traj), rng=rng)
    before = sense_normal_cuda.launches
    xg, rg = gpu(y, return_resids=True)
    assert (sense_normal_cuda.launches - before
            == LAUNCHES_PER_CALL * 8 * (nc // 2))
    xc, rc = cpu(y, return_resids=True)
    assert rel_err(xg, xc) < 1e-4
    assert rel_err(rg, rc) < 1e-4


# ---- Toeplitz round trip K2 (K1's family without the coil fusion) --------

@pytest.mark.parametrize("shape,B", [((8, 8, 8), 2), ((8, 16, 24), 3),
                                     ((16, 136, 8), 1), ((24, 8, 136), 2),
                                     ((24, 136, 40), 2), ((8, 256, 16), 3),
                                     ((128, 16, 256), 2),
                                     ((256, 256, 256), 8)])
def test_toeplitz_kernel_matches_plain(cuda, shape, B):
    from indigo_tpu_torch.ops.dft_cuda import (
        toeplitz_apply_cuda, toeplitz_apply_reference)

    T, _, u = _inputs(np.random.default_rng(7), shape, B, 1, cuda)
    before = toeplitz_apply_cuda.launches
    planes = toeplitz_apply_cuda.plane_calls
    out = toeplitz_apply_cuda(T, u)
    torch.cuda.synchronize()
    assert toeplitz_apply_cuda.launches == before + LAUNCHES_PER_CALL
    assert toeplitz_apply_cuda.plane_calls == planes + 1
    assert rel_err(out, toeplitz_apply_reference(T, u)) < 1e-4


def test_toeplitz_kernel_rejects_what_it_does_not_take(cuda):
    from indigo_tpu_torch.ops.dft_cuda import toeplitz_apply_cuda

    T, _, u = _inputs(np.random.default_rng(8), (8, 8, 8), 2, 1, cuda)
    before = toeplitz_apply_cuda.launches
    with pytest.raises(TypeError):
        toeplitz_apply_cuda(T, u.to(torch.complex128))
    with pytest.raises(ValueError):
        toeplitz_apply_cuda(T, u.transpose(1, 3))
    T2, _, u2 = _inputs(np.random.default_rng(8), (12, 8, 8), 1, 1, cuda)
    with pytest.raises(ValueError):
        toeplitz_apply_cuda(T2, u2)
    shifted = torch.empty(T.numel() + 1, device=cuda)[1:].view(T.shape)
    shifted.copy_(T)
    with pytest.raises(ValueError):
        toeplitz_apply_cuda(shifted, u)
    assert toeplitz_apply_cuda.launches == before


def test_toeplitz_normal_on_cuda_runs_the_kernel(cuda):
    from indigo_tpu_torch.ops.dft_cuda import (
        toeplitz_apply_cuda, toeplitz_apply_reference)
    from indigo_tpu_torch.toeplitz import ToeplitzNormal, \
        sense_normal_toeplitz

    rng = np.random.default_rng(9)
    img, nc = (8, 16, 8), 3
    Tf = rng.standard_normal(tuple(2 * s for s in img)).astype(np.float32)
    maps = rand64c(nc, *img, rng=rng)
    x = torch.from_numpy(rand64c(int(np.prod(img)), 2, rng=rng))
    K = ToeplitzNormal(Tf, img, device="cpu")
    N = sense_normal_toeplitz(Tf, maps, device="cpu")
    ref_k, ref_n = K * x, N * x
    K, N = K.to(cuda), N.to(cuda)
    plain = toeplitz_apply_reference.cuda_calls
    before = toeplitz_apply_cuda.launches
    out_k, out_n = K * x.to(cuda), N * x.to(cuda)
    torch.cuda.synchronize()
    assert toeplitz_apply_cuda.launches == before + 2 * LAUNCHES_PER_CALL
    assert toeplitz_apply_reference.cuda_calls == plain
    assert rel_err(out_k, ref_k) < 1e-4
    assert rel_err(out_n, ref_n) < 1e-4


def test_toeplitz_cg_from_64bit_numpy_runs_k2(cuda):
    """The reference user's recipe: float64 / complex128 numpy and no
    device anywhere. The tree builds on the card with complex64 buffers,
    cg runs K2 (3 launches per apply, maxiter + 1 applies) and equals the
    solve built from complex64 tensors on the card (1e-4)."""
    from indigo_tpu_torch import cg
    from indigo_tpu_torch.ops.dft_cuda import toeplitz_apply_cuda
    from indigo_tpu_torch.toeplitz import sense_normal_toeplitz

    rng = np.random.default_rng(11)
    img, nc, iters = (32, 32, 32), 4, 6
    Tf = np.abs(rng.standard_normal(tuple(2 * s for s in img))) + 0.5
    maps = (rng.standard_normal((nc,) + img)
            + 1j * rng.standard_normal((nc,) + img))
    b = rng.standard_normal(32 ** 3) + 1j * rng.standard_normal(32 ** 3)
    N = sense_normal_toeplitz(Tf, maps)
    assert all(t.is_cuda and t.dtype in (torch.complex64, torch.float32)
               for t in N.buffers())
    before = toeplitz_apply_cuda.launches
    x, _ = cg(N, b, lamda=0.1, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    assert toeplitz_apply_cuda.launches - before == \
        LAUNCHES_PER_CALL * (iters + 1)
    assert x.is_cuda and x.dtype == torch.complex64
    N32 = sense_normal_toeplitz(
        torch.from_numpy(Tf.astype(np.float32)).to(cuda),
        torch.from_numpy(maps.astype(np.complex64)).to(cuda), device=cuda)
    x32, _ = cg(N32, torch.from_numpy(b.astype(np.complex64)).to(cuda),
                lamda=0.1, tol=0.0, maxiter=iters)
    assert rel_err(x, x32) < 1e-4


@pytest.mark.parametrize("S", [1, 3])
def test_cg_inner_products_on_the_card_match_the_host(cuda, S):
    """The CG loop's per-row inner products: one vdot a row on the card,
    the summed products on the host; equal to f32 rounding (1e-6)."""
    from indigo_tpu_torch.solvers import _rowdot

    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rand64c(S, 4096, rng=rng)) for _ in range(2))
    got = _rowdot(a.to(cuda), b.to(cuda))
    assert got.shape == (S, 1) and got.is_cuda
    assert rel_err(got, _rowdot(a, b)) < 1e-6


def test_card_tensor_never_runs_on_the_host(cuda):
    """A card tensor times an operator built on the host raises, and so do
    batch inputs on two devices: nothing moves the work to the CPU."""
    import indigo_tpu_torch as tit
    from indigo_tpu_torch.parallel.recon import sense_normal_batched

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rand64c(40, 2, rng=rng)).to(cuda)
    for op in (tit.Diag(rand64c(40, rng=rng), device="cpu"),
               tit.DenseMatrix(rand64c(30, 40, rng=rng), device="cpu")):
        with pytest.raises(RuntimeError):
            op * x
    T, m, v = _inputs(rng, (8, 8, 8), 1, 2, cuda)
    with pytest.raises(ValueError):
        sense_normal_batched(T, m, v.reshape(1, -1).cpu(), layout="kernel")


# ---- block-sparse SpMM kernels K3 (jag) and K4 (blocked-ELL) -------------

SPMM_SHAPES = [(64, 256, 8, 0.05), (100, 300, 4, 0.02), (257, 640, 16, 0.01),
               (40, 1000, 8, 0.001), (8, 128, 128, 0.5), (300, 129, 7, 0.05)]


def _sparse(rng, m, n, density):
    import scipy.sparse as sp

    A = sp.random(m, n, density=density, random_state=rng, format="csr",
                  dtype=np.float32)
    A.data = rng.standard_normal(A.nnz).astype(np.float32)
    return A


@pytest.mark.parametrize("bm", [8, 16, 128])
@pytest.mark.parametrize("m,n,k,density", SPMM_SHAPES)
def test_spmm_kernels_match_plain(cuda, bm, m, n, k, density):
    """K3 and K4 against their plain versions on the card at 1e-5 (f32 FMA
    in another order than cuBLAS's batched product)."""
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import (bell_spmm, csr_to_bell, csr_to_jag,
                                         jag_spmm)

    rng = np.random.default_rng(4)
    A = _sparse(rng, m, n, density)
    x = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32))
    x = x.to(cuda)
    for conv, kern, plain in ((csr_to_jag, jag_spmm_cuda, jag_spmm),
                              (csr_to_bell, ell_spmm_cuda, bell_spmm)):
        mat = conv(A, bm=bm).to(cuda)
        before = kern.launches
        y = kern(mat, x)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert y.shape == (m, k)
        assert rel_err(y, plain(mat, x)) < 1e-5
        assert rel_err(y, A @ x.cpu().numpy()) < 1e-5


def test_spmm_kernel_empty_rows_exactly_zero(cuda):
    import scipy.sparse as sp

    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.sparse import csr_to_bell, csr_to_jag

    A = sp.csr_matrix((np.ones(1, np.float32), ([17], [5])), shape=(64, 256))
    x = torch.randn(256, 4, device=cuda)
    for conv in (csr_to_jag, csr_to_bell):
        y = spmm(conv(A).to(cuda), x).cpu().numpy()
        assert (y[:17] == 0).all() and (y[18:] == 0).all()
        np.testing.assert_array_equal(y[17], x[5].cpu().numpy())


def test_spmm_dispatch_complex_x(cuda):
    """Complex x runs the kernel once on its view_as_real columns; a
    complex matrix takes the counted plain path."""
    import scipy.sparse as sp

    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda
    from indigo_tpu_torch.sparse import csr_to_jag

    rng = np.random.default_rng(5)
    A = _sparse(rng, 60, 200, 0.05)
    x = rand64c(200, 3, rng=rng)
    before = jag_spmm_cuda.launches
    y = spmm(csr_to_jag(A).to(cuda), torch.from_numpy(x).to(cuda))
    assert jag_spmm_cuda.launches == before + 1
    assert rel_err(y, A @ x) < 1e-5
    Ac = (A * (1 + 1j)).astype(np.complex64)
    plain = spmm.plain_cuda_calls
    y = spmm(csr_to_jag(sp.csr_matrix(Ac)).to(cuda),
             torch.from_numpy(x).to(cuda))
    assert spmm.plain_cuda_calls == plain + 1
    assert rel_err(y, Ac @ x) < 1e-5


def test_set_spmm_impl_jnp_launches_no_k3(cuda):
    """'auto' and 'pallas' run K3; 'jnp', set or passed per call, runs the
    plain version, counted, and launches no K3; all agree (1e-5)."""
    from indigo_tpu_torch.ops import set_spmm_impl, spmm
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda
    from indigo_tpu_torch.sparse import csr_to_jag

    rng = np.random.default_rng(13)
    A = _sparse(rng, 64, 256, 0.05)
    Aj = csr_to_jag(A).to(cuda)
    x = rand64c(256, 3, rng=rng)
    xd = torch.from_numpy(x).to(cuda)
    cases = (("auto", None, 1, 0), ("jnp", None, 0, 1),
             ("pallas", None, 1, 0), ("auto", "jnp", 0, 1))
    try:
        for impl, per_call, k3, plain in cases:
            set_spmm_impl(impl)
            k3_0, plain_0 = jag_spmm_cuda.launches, spmm.plain_cuda_calls
            y = spmm(Aj, xd, impl=per_call)
            torch.cuda.synchronize()
            assert (jag_spmm_cuda.launches - k3_0,
                    spmm.plain_cuda_calls - plain_0) == (k3, plain), impl
            assert rel_err(y, A @ x) < 1e-5, impl
    finally:
        set_spmm_impl("auto")


def test_float64_conversions_run_the_kernels(cuda):
    """csr_to_jag / csr_to_bell(A_f64, dtype=np.float64) narrow to float32:
    one K3 / K4 launch per apply, none of the plain version, and the
    default conversion's result bitwise."""
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import csr_to_bell, csr_to_jag

    rng = np.random.default_rng(14)
    A = _sparse(rng, 257, 640, 0.01).astype(np.float64)
    x = torch.from_numpy(rand64c(640, 4, rng=rng)).to(cuda)
    for conv, kern in ((csr_to_jag, jag_spmm_cuda),
                       (csr_to_bell, ell_spmm_cuda)):
        mat = conv(A, dtype=np.float64).to(cuda)
        assert mat.nz_val.dtype == torch.float32
        k0, plain = kern.launches, spmm.plain_cuda_calls
        y = spmm(mat, x)
        torch.cuda.synchronize()
        assert (kern.launches - k0, spmm.plain_cuda_calls - plain) == (1, 0)
        assert torch.equal(y, spmm(conv(A).to(cuda), x))


def test_max_eigen_numpy_dtype_on_the_card(cuda):
    import indigo_tpu_torch as tit

    rng = np.random.default_rng(15)
    B = rand64c(6, 6, rng=rng)
    A = tit.DenseMatrix(B @ B.conj().T)
    assert A.A.is_cuda
    lam = tit.max_eigen(A, 6, iters=50, dtype=np.complex64)
    assert lam.is_cuda and lam.dtype == torch.float32
    assert torch.equal(lam, tit.max_eigen(A, 6, iters=50))


def test_spmm_kernels_reject_what_they_do_not_take(cuda):
    """Wrong dtypes, layouts, devices and shapes raise before any launch;
    any bm now runs (the kernel reads the row form, not the tiles)."""
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import (bell_spmm, csr_to_bell, csr_to_jag,
                                         jag_spmm)

    rng = np.random.default_rng(6)
    A = _sparse(rng, 64, 256, 0.05)
    for conv, kern, plain in ((csr_to_jag, jag_spmm_cuda, jag_spmm),
                              (csr_to_bell, ell_spmm_cuda, bell_spmm)):
        mat = conv(A).to(cuda)
        x = torch.randn(256, 8, device=cuda)
        with pytest.raises(TypeError):
            kern(mat, x.double())
        with pytest.raises(ValueError):
            kern(mat, torch.randn(8, 256, device=cuda).T)
        with pytest.raises(ValueError):
            kern(conv(A), x)
        with pytest.raises(ValueError):
            kern(mat, x[:100])
        with pytest.raises(TypeError):
            kern(conv((A * 1j).astype(np.complex64)).to(cuda), x)
        odd = conv(A, bm=24).to(cuda)
        assert rel_err(kern(odd, x), plain(odd, x)) < 1e-5


def _both_kernels(A, bm=16):
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import (bell_spmm, csr_to_bell, csr_to_jag,
                                         jag_spmm)

    return ((csr_to_jag(A, bm=bm), jag_spmm_cuda, jag_spmm),
            (csr_to_bell(A, bm=bm), ell_spmm_cuda, bell_spmm))


@pytest.mark.parametrize("k", [1, 7, 16, 32, 128])
def test_spmm_kernels_any_width(cuda, k):
    """Every lane layout: float4 lanes for K % 4 == 0 (K = 16 the radial
    path's), scalar lanes otherwise, column chunks past one group."""
    rng = np.random.default_rng(10)
    A = _sparse(rng, 300, 700, 0.03)
    x = torch.from_numpy(rng.standard_normal((700, k), dtype=np.float32))
    for mat, kern, plain in _both_kernels(A):
        mat, xc = mat.to(cuda), x.to(cuda)
        y = kern(mat, xc)
        assert rel_err(y, plain(mat, xc)) < 1e-5
        assert rel_err(y, A @ x.numpy()) < 1e-5


def test_spmm_kernels_heavy_row_beside_empty_rows(cuda):
    """A 2,500-nonzero row (split across the warps of one block) and a
    300-nonzero one among empty rows: right, and the empty rows exactly 0."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    n = 4000
    cols = np.r_[rng.choice(n, 2500, replace=False),
                 rng.choice(n, 300, replace=False), [7, 9]]
    rows = np.r_[np.full(2500, 37), np.full(300, 90), [91, 91]]
    A = sp.csr_matrix((rng.standard_normal(len(cols)).astype(np.float32),
                       (rows, cols)), shape=(128, n))
    x = torch.from_numpy(rng.standard_normal((n, 16), dtype=np.float32))
    for mat, kern, plain in _both_kernels(A):
        assert mat.heavy_rows.tolist() == [37, 90]
        mat, xc = mat.to(cuda), x.to(cuda)
        y = kern(mat, xc)
        assert rel_err(y, plain(mat, xc)) < 1e-5
        assert rel_err(y, A @ x.numpy()) < 1e-5
        empty = np.setdiff1d(np.arange(128), [37, 90, 91])
        assert (y[torch.from_numpy(empty).to(cuda)] == 0).all()


def test_spmm_kernels_unaligned_x(cuda):
    """x at a 4-byte offset (not 16-byte aligned) takes the scalar lanes of
    the same kernel and gives the aligned result."""
    rng = np.random.default_rng(12)
    A = _sparse(rng, 200, 500, 0.05)
    x = torch.from_numpy(rng.standard_normal((500, 16), dtype=np.float32))
    for mat, kern, _ in _both_kernels(A):
        mat = mat.to(cuda)
        buf = torch.empty(500 * 16 + 1, device=cuda)
        shifted = buf[1:].view(500, 16)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 and shifted.is_contiguous()
        aligned = kern(mat, x.to(cuda))
        assert rel_err(kern(mat, shifted), aligned) < 1e-6
        assert rel_err(aligned, A @ x.numpy()) < 1e-5


def test_spmm_kernels_bitwise_deterministic_and_equal(cuda):
    """Two launches give the same bits, and K3 and K4 on one matrix (same
    row form) give the same bits, heavy rows included."""
    import scipy.sparse as sp

    rng = np.random.default_rng(13)
    A = sp.random(500, 3000, density=0.01, random_state=rng, format="lil",
                  dtype=np.float32)
    A[5, :] = rng.standard_normal(3000).astype(np.float32)
    A = sp.csr_matrix(A)
    x = torch.from_numpy(rng.standard_normal((3000, 16),
                                             dtype=np.float32)).to(cuda)
    ys = []
    for mat, kern, _ in _both_kernels(A):
        mat = mat.to(cuda)
        assert mat.heavy_rows.tolist() == [5]
        y1, y2 = kern(mat, x), kern(mat, x)
        assert torch.equal(y1, y2)
        ys.append(y1)
    assert torch.equal(ys[0], ys[1])


# ---- the operator algebra, the tree optimizer and FISTA on the card ------
# torch code throughout (no hand-written kernel): each operator on the card
# against itself on the CPU, 1e-5 (f32 sums in another order).

def _new_leaves(rng):
    import indigo_tpu_torch as tit
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp

    traj = rng.uniform(-0.5, 0.5, size=(300, 3))
    A = tit.DenseMatrix(rand64c(24, 30, rng=rng), device="cpu")
    B = tit.DenseMatrix(rand64c(24, 18, rng=rng), device="cpu")
    return {
        "UnscaledFFT": tit.UnscaledFFT((12, 10, 8)),
        "CropPad": tit.CropPad((6, 8, 10), (8, 8, 16)),
        "Mask": tit.Mask(rng.permutation(500)[:200], 500, device="cpu"),
        "Eye": tit.Eye(40),
        "One": tit.One((30, 20)),
        "DenseMatrix": A,
        "KBInterp_halo": tit.KBInterp(plan_tile_interp(
            traj, (20, 20, 20), width=4, beta=6.5), device="cpu"),
        "BlockDiag": tit.BlockDiag([A, B]),
        "HStack": tit.HStack([A, B]),
        "DWT": tit.DWT((16, 32, 16), "db4", levels=1, device="cpu"),
    }


@pytest.mark.parametrize("kind", ["UnscaledFFT", "CropPad", "Mask", "Eye",
                                  "One", "DenseMatrix", "KBInterp_halo",
                                  "BlockDiag", "HStack", "DWT"])
def test_new_operator_cuda_matches_cpu(cuda, kind):
    import copy
    rng = np.random.default_rng(21)
    op = _new_leaves(rng)[kind]
    g = copy.deepcopy(op).to(cuda)
    x = torch.from_numpy(rand64c(op.shape[1], 3, rng=rng))
    y = torch.from_numpy(rand64c(op.shape[0], 3, rng=rng))
    fwd, adj = g * x.to(cuda), g.H * y.to(cuda)
    assert fwd.is_cuda and adj.is_cuda
    assert rel_err(fwd, op * x) < 1e-5
    assert rel_err(adj, op.H * y) < 1e-5
    if g.device is not None:
        assert g.device.type == "cuda"
        # a numpy operand lands on the operator's device
        assert (g * x.numpy()).is_cuda


def _cartesian(rng, n=32, nc=4, **kw):
    from indigo_tpu_torch.models import cartesian_sense_op
    mask = rng.random((n, n)) < 0.4
    mask[n // 2 - 2:n // 2 + 2] = True
    return cartesian_sense_op(mask, rand64c(nc, n, n, rng=rng), **kw)


def test_entry_points_default_to_the_card(cuda):
    """With no ``device`` the model functions return trees on the card, and the
    solvers put a numpy operand or a bare matvec's vectors there."""
    import indigo_tpu_torch as tit
    from indigo_tpu_torch.models import (centered_fft_op, nufft_op,
                                         sense_nufft_op)
    rng = np.random.default_rng(24)
    traj = rng.uniform(-0.5, 0.5, size=(200, 2))
    maps = rand64c(2, 16, 16, rng=rng)
    trees = [_cartesian(rng), centered_fft_op((8, 8)),
             nufft_op(traj, (16, 16))[0], sense_nufft_op(traj, maps)[0],
             nufft_op(traj, (16, 16), interp="sparse", fft="xla")[0],
             tit.DWT((16, 16), "db4", levels=1)]
    for t in trees:
        assert all(b.is_cuda for b in t.buffers()), t.name
    H = torch.from_numpy(
        (np.eye(12) + 0.1 * np.diag(np.arange(12))).astype(np.complex64))
    Hg = H.to(cuda)
    x, info = tit.cg(lambda v: Hg @ v, rand64c(12, rng=rng), maxiter=5)
    assert x.is_cuda and info["resid"].is_cuda
    assert tit.max_eigen(lambda v: Hg @ v, 12, iters=5).is_cuda
    u, _ = tit.apgd(lambda v: Hg @ v, lambda v, a: v, 0.1,
                    np.ones(12, np.complex64), maxiter=3)
    assert u.is_cuda
    uc, _ = tit.apgd(lambda v: H @ v, lambda v, a: v, 0.1,
                     np.ones(12, np.complex64), maxiter=3, device="cpu")
    assert not uc.is_cuda and rel_err(u, uc) < 1e-5


def test_optimize_keeps_the_tree_on_its_device(cuda):
    import indigo_tpu_torch as tit
    rng = np.random.default_rng(22)
    A = _cartesian(rng, device="cpu")
    Nc = (A.H * A).optimize()
    Ag = _cartesian(np.random.default_rng(22))
    Ng = (Ag.H * Ag).optimize()
    assert all(b.is_cuda for b in Ng.buffers())
    kinds = {type(m).__name__ for m in Ng.modules()}
    assert "Mask" not in kinds
    x = torch.from_numpy(rand64c(A.shape[1], 2, rng=rng))
    assert rel_err(Ng * x.to(cuda), Nc * x) < 2e-5
    assert rel_err(Ng * x.to(cuda), Ag.H * (Ag * x.to(cuda))) < 2e-5
    # a fused SpMatrix leaf lands on the card too (and runs K3 there)
    import scipy.sparse as sp
    S = sp.random(40, 50, density=0.2, random_state=3, dtype=np.float32)
    tree = (tit.Diag(rand64c(40, rng=rng).real.copy(), device="cpu")
            * tit.SpMatrix(S, device="cpu"))
    out = tree.to(cuda).optimize()
    assert isinstance(out, tit.SpMatrix)
    assert all(b.is_cuda for b in out.buffers())
    v = torch.from_numpy(rand64c(50, 2, rng=rng))
    assert rel_err(out * v.to(cuda), tree.to("cpu") * v) < 1e-5


def test_cartesian_cg_and_fista_cuda_match_cpu(cuda):
    import indigo_tpu_torch as tit
    rng = np.random.default_rng(23)
    A = _cartesian(rng, device="cpu")
    Ag = _cartesian(np.random.default_rng(23))
    n = A.shape[1]
    x_true = torch.from_numpy(rand64c(n, 1, rng=rng))
    y = A * x_true
    xc, _ = tit.cg((A.H * A).optimize(), A.H * y, lamda=1e-2, tol=0.0,
                   maxiter=20)
    xg, info = tit.cg((Ag.H * Ag).optimize(), Ag.H * y.to(cuda), lamda=1e-2,
                      tol=0.0, maxiter=20)
    assert xg.is_cuda and info["iters"].is_cuda
    assert rel_err(xg, xc) < 1e-4
    Lc = tit.max_eigen(A.H * A, n, iters=30)
    Lg = tit.max_eigen(Ag.H * Ag, n, iters=30)
    assert Lg.is_cuda and abs(float(Lg) - float(Lc)) / float(Lc) < 1e-5
    W = tit.DWT((32, 32), "db4", levels=2, device="cpu")
    Wg = tit.DWT((32, 32), "db4", levels=2)
    lam, step = 2e-3, 1.0 / (1.05 * float(Lc))

    def run(A, W, y):
        def gradf(u):
            r = A.apply(W.apply(u, adjoint=True)) - y
            return W.apply(A.apply(r, adjoint=True))
        return tit.apgd(gradf, lambda v, a: tit.soft_thresh(v, lam * a),
                        step, torch.zeros_like(A.H * y), maxiter=30,
                        history=True)
    uc, ic = run(A, W, y)
    ug, ig = run(Ag, Wg, y.to(cuda))
    assert ug.is_cuda and ig["deltas"].is_cuda
    assert rel_err(ug, uc) < 1e-4
    assert rel_err(ig["deltas"], ic["deltas"]) < 1e-3


# ---- the sharded paths on ranks that share the card ------------------------

def ranks_share_the_card(seed):
    """Two gloo ranks on ``cuda:0``: a (slice, coil) solve through K1 on
    each rank's coils, and the slab solve, against one device."""
    from indigo_tpu_torch.parallel import (
        make_mesh, sense_batch_recon, sense_vol_recon)
    from indigo_tpu_torch.parallel import collectives as C
    from indigo_tpu_torch.toeplitz import toeplitz_kernel

    rng = np.random.default_rng(seed)
    n, nc = 16, 4
    traj = rng.random((400, 3)) - 0.5
    maps = torch.from_numpy(rand64c(nc, n, n, n, rng=rng)).cuda()
    Tf = toeplitz_kernel(traj, (n, n, n), oversamp=2.0, width=6, warn=False,
                         device="cpu")
    lam = 0.05 * float(np.abs(Tf).max())
    rhs = torch.from_numpy(rand64c(2, n ** 3, rng=rng)).cuda()
    mesh = make_mesh(slice=1, coil=2)
    before = sense_normal_cuda.launches
    xm, _ = sense_batch_recon(Tf, maps, rhs, mesh=mesh, lamda=lam, iters=8)
    launches = sense_normal_cuda.launches - before
    x0, _ = sense_batch_recon(Tf, maps, rhs, lamda=lam, iters=8)
    xv, _ = sense_vol_recon(Tf, maps, rhs[0].reshape(n, n, n),
                            make_mesh(vol=2), lamda=lam, iters=8)
    return {"device": str(mesh.device), "transport": C.transport(mesh),
            "launches": launches, "batch": rel_err(xm, x0),
            "slab": rel_err(xv.ravel(), x0[0]), "on_card": xm.is_cuda}


def test_sharded_solves_on_ranks_that_share_the_card(cuda):
    from indigo_tpu_torch.ops._build import load_library
    from indigo_tpu_torch.parallel.launch import launch

    load_library()                  # built once here, loaded by the ranks
    out = launch(ranks_share_the_card, 2, args=(5,), timeout=300.0)
    assert out["device"] == "cuda:0" and out["on_card"]
    assert out["transport"] == "gloo, staged through pinned host memory"
    assert out["launches"] == 8 * LAUNCHES_PER_CALL     # K1, 2 local coils
    assert out["batch"] < 1e-4 and out["slab"] < 1e-4


# ---- the rest of the package: native, backends, profiling, checkpoint ------

def test_native_library_is_available(cuda):
    from indigo_tpu_torch import native
    from indigo_tpu_torch.noncart import interp_mat
    assert native.available(), native._error
    assert native.num_threads() >= 1
    traj = np.random.default_rng(3).uniform(-0.5, 0.5, size=(300, 3))
    a = interp_mat(traj, (16, 16, 20), impl="native")
    b = interp_mat(traj, (16, 16, 20), impl="numpy")
    assert a.nnz == b.nnz and abs(a - b).max() < 1e-5


def test_backend_csrmm_launches_k3(cuda):
    from indigo_tpu_torch.backends import get_backend
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda
    from indigo_tpu_torch.utils import randM
    b = get_backend("cuda")
    assert b.device.type == "cuda"
    rng = np.random.default_rng(4)
    A = randM(200, 300, 0.05, rng=rng, dtype=np.float32)
    X = rand64c(300, 3, rng=rng)
    G = b.SpMatrix(A)
    before = jag_spmm_cuda.launches
    y = b.csrmm(G, X)
    torch.cuda.synchronize()
    assert y.is_cuda and jag_spmm_cuda.launches == before + 1
    assert torch.equal(y, G.apply(torch.from_numpy(X).cuda()))
    assert rel_err(y, A @ X) < 1e-5


def test_time_apply_uses_cuda_events(cuda):
    from indigo_tpu_torch import Diag, UnscaledFFT
    from indigo_tpu_torch.profiling import (measure_hbm_bandwidth,
                                            time_apply)
    assert time_apply(UnscaledFFT((64, 64)), k1=1, k2=3) > 0
    d = Diag(rand64c(4096, rng=5)).to("cuda")
    assert time_apply(d, ncols=2) > 0
    assert measure_hbm_bandwidth(nbytes=1 << 24) > 0


def test_checkpoint_of_a_cuda_tensor_comes_back_on_cuda(cuda, tmp_path):
    from indigo_tpu_torch.checkpoint import load_state, save_state
    x = torch.from_numpy(rand64c(1000, rng=6)).cuda()
    p = save_state(str(tmp_path / "c.npz"), {"x": x, "k": 3})
    out = load_state(p, like={"x": x, "k": 0})
    assert out["x"].is_cuda and torch.equal(out["x"], x) and out["k"] == 3
    assert not load_state(p)["x"].is_cuda


# ---- gradients: each kernel's backward launches its adjoint kernel -------

def _k1_k2_cases(cuda, shape=(16, 16, 16), S=2, nc=3):
    """(wrapper, operator tensors, plain version) of K1 and K2, at 16^3
    unless given."""
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_reference, toeplitz_apply_cuda, toeplitz_apply_reference)

    T, m, x = _inputs(np.random.default_rng(15), shape, S, nc, cuda)
    return x, [("K1", sense_normal_cuda, (T, m), sense_normal_reference),
               ("K2", toeplitz_apply_cuda, (T,), toeplitz_apply_reference)]


def test_k1_k2_gradient_is_one_more_launch_on_the_cotangent(cuda):
    """The gradient in the operand is bitwise the kernel on the cotangent
    (both are Hermitian), one call (3 launches) per backward, no plain
    call, and within 1e-4 of autograd through the plain version."""
    _check_k1_k2_gradient(*_k1_k2_cases(cuda))


def test_k1_k2_gradient_at_the_main_path_size(cuda):
    """As above at 256^3: K1 at 4 coils, K2 on the one volume."""
    _check_k1_k2_gradient(*_k1_k2_cases(cuda, (256, 256, 256), 1, 4))


def _check_k1_k2_gradient(x, cases):
    g = torch.randn_like(x)
    for name, fn, ops, plain in cases:
        v = x.clone().requires_grad_()
        out = fn(*ops, v)
        assert out.grad_fn is not None, name
        k0, p0 = fn.launches, plain.cuda_calls
        out.backward(g)
        torch.cuda.synchronize()
        assert (fn.launches - k0, plain.cuda_calls - p0) == \
            (LAUNCHES_PER_CALL, 0), name
        assert torch.equal(v.grad, fn(*ops, g)), name
        vp = x.clone().requires_grad_()
        plain(*ops, vp).backward(g)
        assert rel_err(v.grad, vp.grad) < 1e-4, name


def test_k1_k2_without_grad_launch_directly(cuda):
    """No grad mode or no operand that requires grad: the launch through
    the Function carries no graph and equals the grad path's forward."""
    x, cases = _k1_k2_cases(cuda)
    for name, fn, ops, _ in cases:
        direct = fn(*ops, x)
        assert direct.grad_fn is None and not direct.requires_grad, name
        v = x.clone().requires_grad_()
        with torch.no_grad():
            assert fn(*ops, v).grad_fn is None, name
        assert torch.equal(fn(*ops, v).detach(), direct), name


def test_k1_k2_operator_gradients_raise_on_the_card(cuda):
    x, cases = _k1_k2_cases(cuda)
    for name, fn, ops, _ in cases:
        for i in range(len(ops)):
            grad_ops = list(ops)
            grad_ops[i] = ops[i].clone().requires_grad_()
            k0 = fn.launches
            with pytest.raises(NotImplementedError, match="not ported"):
                fn(*grad_ops, x)
            assert fn.launches == k0, name


@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_spmatrix_gradient_is_the_adjoint_kernel(cuda, fmt):
    """SpMatrix in both directions: the gradient is bitwise the other
    direction's product, one K3/K4 launch per backward, no plain call;
    a complex operand's gradient comes back complex."""
    import indigo_tpu_torch as tit
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import bell_spmm, jag_spmm

    kern = jag_spmm_cuda if fmt == "jag" else ell_spmm_cuda
    rng = np.random.default_rng(16)
    A = _sparse(rng, 257, 640, 0.01)
    op = tit.SpMatrix(A, format=fmt, device=cuda)
    for adjoint in (False, True):
        M, N = op.shape[::-1] if adjoint else op.shape
        for x in (torch.from_numpy(rand64c(N, 3, rng=rng)),
                  torch.randn(N, 4)):
            x = x.to(cuda).requires_grad_()
            g = torch.randn((M,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=cuda)
            y = op.apply(x, adjoint=adjoint)
            k0, p0 = kern.launches, spmm.plain_cuda_calls
            y.backward(g)
            torch.cuda.synchronize()
            assert (kern.launches - k0, spmm.plain_cuda_calls - p0) == (1, 0)
            assert x.grad.dtype == x.dtype
            assert torch.equal(x.grad, op.apply(g, adjoint=not adjoint))
            xp = x.detach().clone().requires_grad_()
            E = op.ellH if adjoint else op.ell
            plain = jag_spmm if fmt == "jag" else bell_spmm
            plain(E, xp).backward(g)
            assert rel_err(x.grad, xp.grad) < 1e-5


def test_spmm_gradients_not_ported_raise_on_the_card(cuda):
    """A bare spmm or kernel call with x requiring grad has no adjoint to
    launch, and matrix values that require grad are not ported: both
    raise, before any launch; without grad the bare call still runs."""
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import csr_to_bell, csr_to_jag

    rng = np.random.default_rng(17)
    A = _sparse(rng, 64, 256, 0.05)
    x = torch.randn(256, 2, device=cuda)
    xg = x.clone().requires_grad_()
    for conv, kern in ((csr_to_jag, jag_spmm_cuda),
                       (csr_to_bell, ell_spmm_cuda)):
        mat, matH = conv(A).to(cuda), conv(A.T.tocsr()).to(cuda)
        k0 = kern.launches
        for call in (lambda: spmm(mat, xg), lambda: kern(mat, xg)):
            with pytest.raises(NotImplementedError, match="no adjoint"):
                call()
        mat.nz_val.requires_grad_()
        with pytest.raises(NotImplementedError, match="nz_val"):
            spmm(mat, x, AH=matH)
        assert kern.launches == k0
        mat.nz_val.requires_grad_(False)
        assert kern(mat, x).grad_fn is None
        assert spmm(mat, xg, AH=matH).grad_fn is not None


def test_recon_gradient_on_the_card_matches_cpu(cuda):
    """SenseRecon's rhs -> solve differentiates through K1 on the card:
    with coil_chunk 2 of 4 coils, 2 K1 calls per CG iteration forward and
    2 backward, no plain call, and the card's gradient within 1e-4 of the
    CPU's plain one."""
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.ops.dft_cuda import sense_normal_reference

    rng = np.random.default_rng(18)
    n, nc, iters = 32, 4, 5
    dirs = rng.standard_normal((256, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(32) - 16) / 32
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + rand64c(nc, n, n, n, rng=rng) * 0.1).astype(np.complex64)
    kw = dict(oversamp=1.25, width=4, iters=iters, coil_chunk=2)
    y = rand64c(nc * len(traj), rng=rng)
    c = rand64c(n ** 3, rng=rng)
    grads = []
    for dev in ("cuda", "cpu"):
        rec = SenseRecon(traj, maps, device=dev, **kw)
        yt = torch.from_numpy(y).to(dev).requires_grad_()
        x = rec.solve(rec.rhs(yt))[0]
        k0, p0 = sense_normal_cuda.launches, sense_normal_reference.cuda_calls
        (torch.from_numpy(c).to(dev).conj() * x).real.sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sense_normal_cuda.launches - k0 == \
                LAUNCHES_PER_CALL * 2 * iters
            assert sense_normal_reference.cuda_calls == p0
        grads.append(yt.grad.cpu())
    assert torch.isfinite(grads[0]).all()
    assert rel_err(grads[0], grads[1]) < 1e-4


# ---- the program's layer spans on the card (``tracing``) ------------------

def _recon64(device):
    """A 64^3 SenseRecon on ``device`` (4 coils, 3 CG steps, K1 in chunks
    of 2), the generator it was made from, and one acquisition for it."""
    from indigo_tpu_torch.models import SenseRecon

    rng = np.random.default_rng(19)
    n, nc = 64, 4
    dirs = rng.standard_normal((1024, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(n) - n // 2) / n
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + rand64c(nc, n, n, n, rng=rng) * 0.1).astype(np.complex64)
    rec = SenseRecon(traj, maps, iters=3, coil_chunk=2, device=device)
    assert rec.layout == "kernel"
    return rec, rng, rand64c(nc * len(traj), rng=rng)


@pytest.fixture
def recon64(cuda):
    """``_recon64`` on the current card."""
    return _recon64("cuda")


@pytest.fixture
def traced_recon(recon64):
    """One call of ``recon64`` under a CUDA profiler: (its request spans,
    the profiler's events)."""
    from torch.profiler import ProfilerActivity, profile

    from indigo_tpu_torch import tracing

    rec, _, y = recon64
    rec(y)
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rec(y)
        torch.cuda.synchronize()
    recs = tracing.spans()
    tracing.clear()
    return recs, list(prof.profiler.kineto_results.events())


def test_spans_add_no_device_event(traced_recon):
    recs, events = traced_recon
    on_card = [e for e in events if "CUDA" in str(e.device_type())]
    assert on_card
    for e in on_card:
        assert not e.name().startswith("indigo."), e.name()
        assert not e.is_user_annotation(), e.name()
    host = [e.name() for e in events if e.name().startswith("indigo.")]
    assert sorted(host) == sorted(s.name for s in recs)


def test_span_device_ms_on_the_card(traced_recon):
    from indigo_tpu_torch.tracing import self_ms

    recs, _ = traced_recon
    assert [s.name for s in recs].count("indigo.normal_op") == 3
    assert all(s.device_ms > 0 for s in recs), recs
    one = {s.name: s for s in recs}
    normal = [s for s in recs if s.name == "indigo.normal_op"]
    assert one["indigo.solve"].device_ms >= sum(s.device_ms for s in normal)
    assert self_ms(one["indigo.solve"], recs, ("indigo.normal_op",)) >= 0
    assert one["indigo.rhs"].device_ms >= one["indigo.ingress"].device_ms


# ---- the image's way to host memory (``models.recon.host_copy``) ----------

def _copies():
    from indigo_tpu_torch.models.recon import host_copy
    return host_copy.pinned_copies, host_copy.pageable_copies


def _kept_solves(rec, monkeypatch):
    """The device image of every solve ``rec`` runs from now on."""
    seen, solve = [], rec.solve

    def keep(rhs):
        out = solve(rhs)
        seen.append(out[0].reshape(rec.img_shape))
        return out

    monkeypatch.setattr(rec, "solve", keep)
    return seen


def test_recon_image_is_the_device_tensor_in_pinned_memory(recon64,
                                                           monkeypatch):
    rec, _, y = recon64
    seen = _kept_solves(rec, monkeypatch)
    pinned, pageable = _copies()
    img = rec(y)
    assert _copies() == (pinned + 1, pageable)
    np.testing.assert_array_equal(img, seen[0].cpu().numpy())
    assert img.dtype == np.complex64 and img.shape == rec.img_shape
    assert torch.from_numpy(img).is_pinned()
    dev = rec(y, output="device")
    assert dev.is_cuda and _copies() == (pinned + 1, pageable)
    k = rec.simulate(img)
    assert _copies() == (pinned + 2, pageable)
    assert torch.from_numpy(k).is_pinned()
    assert rel_err(k, rec.simulate(dev)) < 1e-5


def test_recon_images_held_at_once_are_their_own(recon64):
    rec, rng, y = recon64
    first = rec(y)
    kept = first.copy()
    second = rec(rand64c(*y.shape, rng=rng))
    third = rec(y)
    torch.cuda.synchronize()
    for a, b in ((first, second), (first, third), (second, third)):
        assert not np.shares_memory(a, b)
    np.testing.assert_array_equal(first, kept)
    assert rel_err(second, kept) > 1e-2
    assert rel_err(third, kept) < 1e-5


def test_stream_images_are_pinned_and_equal_the_calls(recon64, monkeypatch):
    rec, rng, y = recon64
    ys = [y] + [rand64c(*y.shape, rng=rng) for _ in range(2)]
    calls = [rec(v) for v in ys]
    seen = _kept_solves(rec, monkeypatch)
    pinned, pageable = _copies()
    out = list(rec.stream(ys))
    assert _copies() == (pinned + 3, pageable)
    assert len(out) == len(seen) == 3
    for x, dev, call in zip(out, seen, calls):
        assert torch.from_numpy(x).is_pinned()
        np.testing.assert_array_equal(x, dev.cpu().numpy())
        assert rel_err(x, call) < 1e-5
    assert not np.shares_memory(out[0], out[1])


# ---- a pipeline on a card that is not the current one ---------------------

@pytest.fixture
def second_card(cuda):
    """cuda:1, while cuda:0 stays the current card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def test_recon_on_a_second_card_returns_its_image(second_card, monkeypatch):
    """``__call__``, ``stream`` and ``simulate`` of a pipeline on cuda:1
    while cuda:0 is current: each array, read the moment it is returned,
    is its solve's image or k-space. The second round runs on new data in
    the pinned blocks the first left in torch's cache: a new block's
    cudaHostAlloc waits for the card, which would hide a missing wait."""
    rec, rng, y = _recon64(second_card)
    seen = _kept_solves(rec, monkeypatch)
    assert torch.cuda.current_device() == 0
    allocs = []
    for _ in range(2):
        ys = [rand64c(*y.shape, rng=rng) for _ in range(3)]
        seen.clear()
        img = rec(ys[0])
        got = [img.copy()]              # before anything waits on cuda:1
        got += [x.copy() for x in rec.stream(ys[1:])]
        k = rec.simulate(img)
        k_got = k.copy()
        assert len(seen) == 3
        for x, dev in zip(got, seen):
            assert dev.device == second_card
            np.testing.assert_array_equal(x, dev.cpu().numpy())
        assert torch.from_numpy(img).is_pinned()
        np.testing.assert_array_equal(k_got, k)
        assert rel_err(k, rec.simulate(seen[0])) < 1e-5
        del img, k
        torch.cuda.synchronize(second_card)
        allocs.append(torch.cuda.host_memory_stats()["num_host_alloc"])
    assert allocs[1] == allocs[0]


# ---- the adjoint centered pad-DFT (csrc/pad_dft.cu) ----------------------

# (img, grid, K): small 2D / 3D shapes over the factor plans, then the main
# path's 320^3 -> 256^3 at 8 coils
PAD_DFT_SHAPES = [((13, 31), (24, 40), 1), ((29, 51), (40, 64), 8),
                  ((12, 16, 256), (16, 24, 320), 8),
                  ((25, 7, 200), (32, 16, 256), 1),
                  ((64, 60, 70), (80, 64, 80), 2),
                  ((100, 128, 20), (128, 160, 32), 1),
                  ((13, 301), (16, 512), 2),
                  ((256, 256, 256), (320, 320, 320), 8)]


def _pad_dft_case(cuda, img, grid, K, seed=20):
    from indigo_tpu_torch.operators import CenteredDFT

    x = torch.from_numpy(rand64c(K, *grid, rng=np.random.default_rng(seed)))
    return x.to(cuda), CenteredDFT(img, grid, device=cuda)


@pytest.mark.parametrize("img,grid,K", PAD_DFT_SHAPES)
def test_pad_idft_kernel_matches_plain(cuda, img, grid, K):
    from indigo_tpu_torch.ops.pad_dft_cuda import (
        pad_idft_cuda, pad_idft_reference)

    x, _ = _pad_dft_case(cuda, img, grid, K)
    before = pad_idft_cuda.launches
    out = pad_idft_cuda(x, img)
    torch.cuda.synchronize()
    assert pad_idft_cuda.launches == before + len(img)
    assert out.shape == (K,) + img and out.is_contiguous()
    assert rel_err(out, pad_idft_reference(x, img)) < 1e-5


def test_pad_idft_launches_on_the_adjoint_only(cuda):
    """One launch per axis on a GridDFT / CenteredDFT adjoint apply on the
    card; none on a forward apply or on the CPU."""
    from indigo_tpu_torch.operators import GridDFT
    from indigo_tpu_torch.ops.pad_dft_cuda import pad_idft_cuda
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp

    rng = np.random.default_rng(21)
    img = (32, 32, 32)
    coords = rng.uniform(-0.5, 0.5, (500, 3))
    plan = plan_tile_interp(coords, (40, 40, 40), width=4, beta=6.5)
    G = GridDFT(plan, img, device=cuda)
    Gc = GridDFT(plan, img, device="cpu")
    y = torch.from_numpy(rand64c(plan.n_samples, 2, rng=rng))
    before = pad_idft_cuda.launches
    xa = G.apply(y.to(cuda), adjoint=True)
    assert pad_idft_cuda.launches == before + 3
    assert rel_err(xa, Gc.apply(y, adjoint=True)) < 1e-5
    G.apply(xa)
    Gc.apply(y, adjoint=True)
    assert pad_idft_cuda.launches == before + 3
    x, D = _pad_dft_case(cuda, (13, 31), (24, 40), 3)
    D.apply(x.reshape(3, -1).T, adjoint=True)
    assert pad_idft_cuda.launches == before + 5


def test_pad_idft_gradient_matches_plain(cuda):
    """The Function's gradient (the forward pad-DFT on the cotangent)
    against autograd through the plain version; no launch in backward."""
    from indigo_tpu_torch.ops.pad_dft_cuda import (
        pad_idft_cuda, pad_idft_reference)

    img, grid = (29, 51), (40, 64)
    x0, _ = _pad_dft_case(cuda, img, grid, 2)
    g = torch.from_numpy(rand64c(2, *img, rng=np.random.default_rng(22)))
    g = g.to(cuda)
    grads = []
    for f in (pad_idft_cuda, pad_idft_reference):
        x = x0.clone().requires_grad_(True)
        out = f(x, img)
        assert out.grad_fn is not None
        before = pad_idft_cuda.launches
        out.backward(g)
        assert pad_idft_cuda.launches == before
        grads.append(x.grad)
    assert rel_err(grads[0], grads[1]) < 1e-5


def test_pad_idft_rejects_what_it_does_not_take(cuda):
    from indigo_tpu_torch.ops.pad_dft_cuda import pad_idft_cuda

    x, _ = _pad_dft_case(cuda, (13, 31), (24, 40), 2)
    with pytest.raises(TypeError):
        pad_idft_cuda(x.to(torch.complex128), (13, 31))
    with pytest.raises(ValueError):
        pad_idft_cuda(x.transpose(1, 2), (31, 13))
    with pytest.raises(ValueError):
        pad_idft_cuda(x, (13, 41))                  # n > g
    y, _ = _pad_dft_case(cuda, (13, 13), (20, 20), 1)
    with pytest.raises(ValueError):
        pad_idft_cuda(y, (13, 13))                  # g 20 has no plan


def test_recon_rhs_on_the_card_matches_the_plain_route(cuda, monkeypatch):
    """SenseRecon.rhs through the kernel against the same pipeline with the
    predicate refusing every shape (the adjoint matrices on the card)."""
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.ops import pad_dft_cuda

    rng = np.random.default_rng(23)
    n, nc = 32, 4
    dirs = rng.standard_normal((256, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(32) - 16) / 32
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + rand64c(nc, n, n, n, rng=rng) * 0.1).astype(np.complex64)
    rec = SenseRecon(traj, maps, device="cuda", oversamp=1.25, width=4,
                     iters=4)
    y = rand64c(nc * len(traj), rng=rng)
    before = pad_dft_cuda.pad_idft_cuda.launches
    b = rec.rhs(y)
    assert pad_dft_cuda.pad_idft_cuda.launches == before + 3
    monkeypatch.setattr(pad_dft_cuda, "pad_dft_serves", lambda *a: False)
    assert rel_err(b, rec.rhs(y)) < 1e-5
    assert pad_dft_cuda.pad_idft_cuda.launches == before + 3
