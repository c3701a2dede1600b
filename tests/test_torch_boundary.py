"""The port's boundary against the reference's: 64-bit host data.

The reference runs JAX in its default 32-bit mode, so a float64 or
complex128 numpy array handed to it becomes float32 or complex64. Each case
hands the same seeded 64-bit numpy inputs to ``indigo_tpu`` (JAX on the
CPU) and to the port (``device="cpu"``) and asserts the reference's result
dtype, with values within 1e-5 for an operator apply and 1e-4 for a solve
(array-equal for the sparse converters' stored data). A 64-bit ``dtype=``
argument is narrowed the same way.
"""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu_torch.utils import rel_err

OP_TOL, SOLVE_TOL = 1e-5, 1e-4
EQUAL = None       # array-equal


def _c128(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _diag_f64(rng):
    d, x = rng.standard_normal(40), _c128(rng, 40, 2).astype(np.complex64)
    return tit.Diag(d, device="cpu") * x, jit_.Diag(d) * x


def _dense_f64(rng):
    A, x = rng.standard_normal((30, 20)), _c128(rng, 20).astype(np.complex64)
    return tit.DenseMatrix(A, device="cpu") * x, jit_.DenseMatrix(A) * x


def _diag_c128(rng):
    d, x = _c128(rng, 40), _c128(rng, 40, 3)
    port, ref = tit.Diag(d, device="cpu"), jit_.Diag(d)
    assert port.dtype == torch.complex64 == port.d.dtype
    return port * x, ref * x


def _dense_c128(rng):
    A, x = _c128(rng, 12, 16), _c128(rng, 16, 2)
    port, ref = tit.DenseMatrix(A, device="cpu"), jit_.DenseMatrix(A)
    assert port.dtype == torch.complex64 == port.A.dtype
    return port * x, ref * x


def _eye_c128(rng):
    x = _c128(rng, 64)
    return tit.Eye(64, device="cpu") * x, jit_.Eye(64) * x


def _dwt_f64(rng):
    x = rng.standard_normal((64, 2))
    port = tit.DWT((8, 8), "db4", levels=1, device="cpu")
    return port * x, jit_.DWT((8, 8), "db4", levels=1) * x


def _toeplitz_cg(rng):
    from indigo_tpu.toeplitz import sense_normal_toeplitz as j_tree
    img = (8, 8, 16)
    Tf = np.abs(rng.standard_normal(tuple(2 * s for s in img))) + 0.5
    maps, b = _c128(rng, 3, *img), _c128(rng, int(np.prod(img)))
    N = tit.sense_normal_toeplitz(Tf, maps, device="cpu")
    x, _ = tit.cg(N, b, lamda=0.1, tol=0.0, maxiter=8)
    xr, _ = jit_.cg(j_tree(Tf.astype(np.float32), maps), b, lamda=0.1,
                    tol=0.0, maxiter=8)
    return x, xr


def _max_eigen(rng):
    B = rng.standard_normal((6, 6))
    A = B @ B.T + np.diag([9.0, 0, 0, 0, 0, 0])   # a well-separated top
    lam = tit.max_eigen(tit.DenseMatrix(A, device="cpu"), 6, iters=200)
    return lam, jit_.max_eigen(jit_.DenseMatrix(A), 6, iters=200)


def _hermitian(rng, n=6):
    B = _c128(rng, n, n)
    return B @ B.conj().T + np.diag([9.0] + [0.0] * (n - 1))


def _max_eigen_dtype(dtype):
    """max_eigen with a numpy dtype=: complex on a Hermitian operator, real
    on a real one (the reference refuses float32 on a complex operator)."""
    def build(rng):
        if np.issubdtype(dtype, np.complexfloating):
            A = _hermitian(rng)
        else:
            B = rng.standard_normal((6, 6))
            A = B @ B.T + np.diag([9.0, 0, 0, 0, 0, 0])
        lam = tit.max_eigen(tit.DenseMatrix(A, device="cpu"), 6, iters=200,
                            dtype=dtype)
        return lam, jit_.max_eigen(jit_.DenseMatrix(A), 6, iters=200,
                                   dtype=dtype)
    return build


def _leaf_c128(leaf):
    """An array-less leaf built with dtype=np.complex128, times complex64."""
    def build(rng):
        from indigo_tpu.models import centered_fft_op as j_centered
        from indigo_tpu_torch.models import centered_fft_op
        x = _c128(rng, 64, 2).astype(np.complex64)
        port, ref = {
            "UnscaledFFT": lambda **k: (
                tit.UnscaledFFT((8, 8), dtype=np.complex128, **k),
                jit_.UnscaledFFT((8, 8), dtype=np.complex128)),
            "One": lambda **k: (tit.One((5, 64), dtype=np.complex128, **k),
                                jit_.One((5, 64), dtype=np.complex128)),
            "centered_fft_op": lambda **k: (
                centered_fft_op((8, 8), dtype=np.complex128, **k),
                j_centered((8, 8), dtype=np.complex128)),
        }[leaf](device="cpu")
        assert port.dtype == torch.complex64
        return port * x, ref * x
    return build


def _sparse_f64(fmt):
    """csr_to_<fmt>(G_f64, dtype=np.float64): the stored data, built from a
    COO matrix with duplicate entries (summed in float64, then narrowed)."""
    def build(rng):
        import scipy.sparse as sp
        rows, cols = rng.integers(0, 40, 600), rng.integers(0, 300, 600)
        A = sp.coo_matrix((rng.standard_normal(600), (rows, cols)),
                          shape=(40, 300))
        conv = "csr_to_" + fmt
        port = getattr(tit.sparse, conv)(A, dtype=np.float64)
        ref = getattr(jit_.sparse, conv)(A, dtype=np.float64)
        if fmt != "element":          # the row form K3/K4 read
            assert port.nz_val.dtype == torch.float32
        return port.data, ref.data
    return build


def _soft_thresh(rng):
    x = rng.standard_normal(50)
    return tit.soft_thresh(x, 0.1, device="cpu"), jit_.soft_thresh(x, 0.1)


def _apgd(rng):
    B, y = rng.standard_normal((20, 12)), rng.standard_normal(20)
    AtA, Atb = B.T @ B, B.T @ y
    alpha = 1.0 / np.linalg.eigvalsh(AtA).max()
    x0 = rng.standard_normal(12)
    G = tit.DenseMatrix(AtA, device="cpu")
    atb = torch.from_numpy(Atb.astype(np.float32))
    x, _ = tit.apgd(lambda z: G * z - atb,
                    lambda v, a: tit.soft_thresh(v, 0.05 * a), alpha, x0,
                    maxiter=40, device="cpu")
    Gj = jit_.DenseMatrix(AtA)
    xr, _ = jit_.apgd(lambda z: Gj * z - Atb.astype(np.float32),
                      lambda v, a: jit_.soft_thresh(v, 0.05 * a), alpha, x0,
                      maxiter=40)
    return x, xr


# case: (what makes both results, the reference's dtype, tolerance)
CASES = {
    "Diag(d_f64) * x_c64": (_diag_f64, torch.complex64, OP_TOL),
    "DenseMatrix(A_f64) * x_c64": (_dense_f64, torch.complex64, OP_TOL),
    "Diag(d_c128)": (_diag_c128, torch.complex64, OP_TOL),
    "DenseMatrix(A_c128)": (_dense_c128, torch.complex64, OP_TOL),
    "Eye(64) * x_c128": (_eye_c128, torch.complex64, OP_TOL),
    "DWT * x_f64": (_dwt_f64, torch.float32, OP_TOL),
    "cg(sense_normal_toeplitz(Tf, maps_c128), b_c128)":
        (_toeplitz_cg, torch.complex64, SOLVE_TOL),
    "max_eigen(DenseMatrix(A_f64), 6)": (_max_eigen, torch.float32,
                                         SOLVE_TOL),
    "soft_thresh(x_numpy, 0.1)": (_soft_thresh, torch.float32, OP_TOL),
    "apgd(..., x0_f64)": (_apgd, torch.float32, SOLVE_TOL),
    # a 64-bit dtype= is narrowed, and max_eigen takes numpy dtypes
    "UnscaledFFT(dtype=np.complex128) * x_c64": (
        _leaf_c128("UnscaledFFT"), torch.complex64, OP_TOL),
    "One(dtype=np.complex128) * x_c64": (
        _leaf_c128("One"), torch.complex64, OP_TOL),
    "centered_fft_op(dtype=np.complex128) * x_c64": (
        _leaf_c128("centered_fft_op"), torch.complex64, OP_TOL),
    "csr_to_jag(A_f64, dtype=np.float64).data": (
        _sparse_f64("jag"), torch.float32, EQUAL),
    "csr_to_bell(A_f64, dtype=np.float64).data": (
        _sparse_f64("bell"), torch.float32, EQUAL),
    "csr_to_element(A_f64, dtype=np.float64).data": (
        _sparse_f64("element"), torch.float32, EQUAL),
    "max_eigen(Hermitian, 6, dtype=np.complex64)": (
        _max_eigen_dtype(np.complex64), torch.float32, SOLVE_TOL),
    "max_eigen(Hermitian, 6, dtype=np.complex128)": (
        _max_eigen_dtype(np.complex128), torch.float32, SOLVE_TOL),
    "max_eigen(DenseMatrix(A_f64), 6, dtype=np.float32)": (
        _max_eigen_dtype(np.float32), torch.float32, SOLVE_TOL),
}


@pytest.mark.parametrize("case", list(CASES))
def test_64bit_host_data_is_narrowed_as_the_reference_does(case):
    build, dtype, tol = CASES[case]
    port, ref = build(np.random.default_rng(0))
    ref = np.array(ref)
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu"
    assert port.dtype == dtype
    assert torch.from_numpy(ref).dtype == dtype     # the reference's own
    assert tuple(port.shape) == ref.shape
    if tol is EQUAL:
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        assert rel_err(port, ref) < tol, case
