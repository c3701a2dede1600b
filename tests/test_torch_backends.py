"""The port's backend facade against ``indigo_tpu.backends`` on the same
inputs (1e-5), with ``device="cpu"``: the registry, the factories and
``cg``, and every primitive. Its default device is the card."""
import numpy as np
import pytest
import torch

import indigo_tpu.backends as jb
import indigo_tpu_torch.backends as tb
from indigo_tpu.utils import rand64c, randM
from indigo_tpu_torch.utils import rel_err

NAMES = ("xla", "numpy", "mkl", "cuda", "customcpu", "customgpu")


def test_names_equal_the_reference():
    assert sorted(tb.__all__) == sorted(jb.__all__)


def test_registry():
    b = tb.get_backend(device="cpu")
    assert b is tb.get_backend("xla", device="cpu")
    assert b is tb.get_backend("XLA", device=torch.device("cpu"))
    for name in NAMES:
        assert tb.get_backend(name, device="cpu").device.type == "cpu"
        assert tb.get_backend(name).device.type == "cuda"
        assert tb.get_backend(name) is tb.get_backend(name, device="cuda")
    assert tb.get_backend("mkl") is not tb.get_backend("mkl", device="cpu")
    want = ["cuda"] if torch.cuda.is_available() else ["cpu"]
    assert tb.available_backends() == want
    assert "cpu" in repr(b)


def test_default_device_is_the_card(rng):
    b = tb.get_backend("numpy")
    x = rand64c(8, rng=rng)
    if torch.cuda.is_available():
        assert b.copy_from(x).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            b.copy_from(x)


def test_factories_and_cg(rng):
    b, r = tb.get_backend(device="cpu"), jb.get_backend()
    M = randM(20, 30, 0.2, rng=rng)
    d = rand64c(30, rng=rng)
    T = b.SpMatrix(M) * b.UnscaledFFT((30,)) * b.Diag(d)
    R = r.SpMatrix(M) * r.UnscaledFFT((30,)) * r.Diag(d)
    assert T.shape == (20, 30)
    x = rand64c(30, rng=rng)
    y = T * x
    assert rel_err(y, np.asarray(R * x)) < 1e-5
    AHy = T.H * y
    xr, info = b.cg(T.H * T, AHy, lamda=1.0, maxiter=50)
    assert xr.device.type == "cpu" and torch.isfinite(xr).all()
    # against the reference where the f32 solve is well conditioned (at
    # lamda 1 the two stop at tol 1e-6 about 3e-5 apart)
    xr, _ = b.cg(T.H * T, AHy, lamda=100.0, maxiter=50)
    xj, _ = r.cg(R.H * R, np.asarray(R.H * np.asarray(R * x)), lamda=100.0,
                 maxiter=50)
    assert rel_err(xr, np.asarray(xj)) < 1e-5


def _operators(b, rng):
    """Every factory, with what to compare against the reference's."""
    D = rand64c(6, 4, rng=rng)
    d = rand64c(4, rng=rng)
    M = randM(5, 4, 0.5, rng=rng)
    return {
        "SpMatrix": lambda p: p.SpMatrix(M),
        "DenseMatrix": lambda p: p.DenseMatrix(D),
        "Diag": lambda p: p.Diag(d),
        "UnscaledFFT": lambda p: p.UnscaledFFT((2, 2)),
        "Eye": lambda p: p.Eye(4),
        "One": lambda p: p.One((3, 4)),
        "CropPad": lambda p: p.CropPad((2, 2), (4, 3)),
        "KronI": lambda p: p.KronI(2, p.Diag(d)),
        "BlockDiag": lambda p: p.BlockDiag([p.Diag(d), p.DenseMatrix(D)]),
        "VStack": lambda p: p.VStack([p.Diag(d), p.DenseMatrix(D)]),
        "HStack": lambda p: p.HStack([p.DenseMatrix(D), p.DenseMatrix(D)]),
        "Scale": lambda p: p.Scale(2.5, p.DenseMatrix(D)),
    }


@pytest.mark.parametrize("name", ["SpMatrix", "DenseMatrix", "Diag",
                                  "UnscaledFFT", "Eye", "One", "CropPad",
                                  "KronI", "BlockDiag", "VStack", "HStack",
                                  "Scale"])
def test_factory_matches_the_reference(rng, name):
    b, r = tb.get_backend("cuda", device="cpu"), jb.get_backend("cuda")
    make = _operators(b, rng)[name]
    T, R = make(b), make(r)
    assert T.shape == tuple(R.shape)
    assert all(t.device.type == "cpu" for t in T.buffers())
    x = rand64c(T.shape[1], 2, rng=rng)
    assert rel_err(T * x, np.asarray(R * x)) < 1e-5
    y = rand64c(T.shape[0], 2, rng=rng)
    assert rel_err(T.H * y, np.asarray(R.H * y)) < 1e-5


def _primitives(rng):
    A = randM(10, 12, 0.3, rng=rng)
    X = rand64c(12, 2, rng=rng)
    Y = rand64c(10, 2, rng=rng)
    v = rand64c(6, 3, rng=rng)
    M = rand64c(5, 6, rng=rng)
    x, y = rand64c(8, rng=rng), rand64c(8, rng=rng)
    return {
        "csrmm": lambda b: b.csrmm(A, X),
        "csrmm_adjoint": lambda b: b.csrmm(A, Y, adjoint=True),
        "fftn": lambda b: b.fftn(v, (6,)),
        "ifftn": lambda b: b.ifftn(v, (6,)),
        "fftn_2d": lambda b: b.fftn(v, (2, 3)),
        "ifftn_2d": lambda b: b.ifftn(v, (3, 2)),
        "cgemm": lambda b: b.cgemm(M, v),
        "cgemm_adjoint": lambda b: b.cgemm(M, M[:, :2], adjoint=True),
        "axpby": lambda b: b.axpby(2.0, x, 3.0, y),
        "dot": lambda b: b.dot(x, y),
        "norm2": lambda b: b.norm2(x),
        "scale": lambda b: b.scale(1.5 - 2j, x),
        "onemm": lambda b: b.onemm(4, x[:, None]),
        "copy_from": lambda b: b.copy_from(v),
        "copy_to": lambda b: b.copy_to(b.copy_from(v)),
        "to_host": lambda b: b.to_host(b.copy_from(x)),
    }


@pytest.mark.parametrize("name", ["csrmm", "csrmm_adjoint", "fftn", "ifftn",
                                  "fftn_2d", "ifftn_2d", "cgemm",
                                  "cgemm_adjoint", "axpby", "dot", "norm2",
                                  "scale", "onemm", "copy_from", "copy_to",
                                  "to_host"])
def test_primitive_matches_the_reference(rng, name):
    from indigo_tpu import cplx
    b, r = tb.get_backend("numpy", device="cpu"), jb.get_backend("numpy")
    call = _primitives(rng)[name]
    got, want = call(b), call(r)
    if isinstance(want, (complex, float)):
        assert type(got) is type(want)
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
        return
    want = cplx.to_numpy(want) if cplx.iscpair(want) else np.asarray(want)
    if name in ("copy_to", "to_host"):
        assert isinstance(got, np.ndarray)
    else:
        assert torch.is_tensor(got) and got.device.type == "cpu"
        got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) < 1e-5


def test_vectors_take_the_matrix_path(rng):
    """A 1-D operand (which the reference's primitives do not take) is one
    column."""
    b = tb.get_backend(device="cpu")
    A = randM(10, 12, 0.3, rng=rng)
    x = rand64c(12, rng=rng)
    assert rel_err(b.csrmm(A, x), A @ x) < 1e-5
    assert rel_err(b.fftn(x, (3, 4)), np.fft.fftn(x.reshape(3, 4)).ravel()) \
        < 1e-5


def test_random_helpers_are_the_references():
    b = tb.get_backend(device="cpu")
    np.testing.assert_array_equal(b.rand64c(3, 2, rng=7), rand64c(3, 2, rng=7))
    assert (b.randM(9, 7, 0.3, rng=7) != randM(9, 7, 0.3, rng=7)).nnz == 0
