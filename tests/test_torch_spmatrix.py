"""SpMatrix, Perm, CenteredDFT and Scale: the port vs the reference
operators, forward and adjoint, at 1e-5 (f32 sums in another order)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import indigo_tpu as jit_
from indigo_tpu.utils import randM
import indigo_tpu_torch as tit
from indigo_tpu_torch.convert import spmatrix_from_reference
from indigo_tpu_torch.operators import Diag, Product
from indigo_tpu_torch.sparse import BlockedELL, BlockedJag, ElementELL
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 1e-5


def _both(jop, top, x, adjoint=False):
    ref = np.asarray((jop.H if adjoint else jop) * x)
    out = (top.H if adjoint else top) * torch.from_numpy(x)
    return out, ref


@pytest.mark.parametrize("fmt,cls", [("jag", BlockedJag), ("bell", BlockedELL),
                                     ("element", ElementELL),
                                     ("auto", BlockedJag)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_spmatrix_matches_reference(fmt, cls, dtype, rng):
    A = randM(120, 333, 0.03, rng=rng, dtype=dtype)
    jop = jit_.SpMatrix(A, format=fmt)
    top = tit.SpMatrix(A, format=fmt, device="cpu")
    assert isinstance(top.ell, cls)
    assert top.shape == jop.shape == A.shape
    x = rand64c(333, 3, rng=rng)
    s = rand64c(120, 3, rng=rng)
    out, ref = _both(jop, top, x)
    assert rel_err(out, ref) < TOL
    out, ref = _both(jop, top, s, adjoint=True)
    assert rel_err(out, ref) < TOL
    flops, bytes_ = top.cost(3)
    assert flops > 0 and bytes_ > 0


def test_spmatrix_auto_format_selects_element(rng):
    """The reference's case: huge, terrible block fill -> element storage."""
    m = 3000
    rows = np.arange(m)
    cols = (rows * 7919) % (1 << 22)
    A = sp.csr_matrix((np.ones(m, np.float32), (rows, cols)),
                      shape=(m, 1 << 22))
    op = tit.SpMatrix(A, device="cpu")
    assert isinstance(op.ell, ElementELL) and op.ellH is None
    assert isinstance(jit_.SpMatrix(A).ell, jit_.sparse.ElementELL)
    x = torch.zeros((1 << 22, 1), dtype=torch.complex64)
    x[cols[5], 0] = 2.0
    assert abs(complex((op * x)[5, 0]) - 2.0) < 1e-6
    s = torch.from_numpy(rand64c(m, 1, rng=rng))
    assert abs(complex((op.H * s)[cols[5], 0] - s[5, 0])) < 1e-5


@pytest.mark.parametrize("fmt", ["jag", "bell", "element"])
def test_spmatrix_from_reference(fmt, rng):
    A = randM(90, 400, 0.02, rng=rng, dtype=np.float32)
    jop = jit_.SpMatrix(A, format=fmt, name="G")
    top = spmatrix_from_reference(jop, device="cpu")
    assert type(top.ell) is type(tit.SpMatrix(A, format=fmt, device="cpu").ell)
    assert top.name == "G"
    x = rand64c(400, 2, rng=rng)
    s = rand64c(90, 2, rng=rng)
    assert rel_err(*_both(jop, top, x)) < TOL
    assert rel_err(*_both(jop, top, s, adjoint=True)) < TOL


def test_perm_matches_reference(rng):
    p = rng.permutation(50)
    jop, top = jit_.Perm(p), tit.Perm(p, device="cpu")
    x = rand64c(50, 3, rng=rng)
    for adj in (False, True):
        out, ref = _both(jop, top, x, adjoint=adj)
        np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(top.perm.numpy(), p)


@pytest.mark.parametrize("img,grid", [((12, 10), (18, 16)), ((16,), (24,)),
                                      ((6, 8, 4), (8, 12, 6))])
def test_centered_dft_matches_reference(img, grid, rng):
    jop = jit_.CenteredDFT(img, grid)
    top = tit.CenteredDFT(img, grid, device="cpu")
    assert top.shape == jop.shape
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    s = rand64c(int(np.prod(grid)), 2, rng=rng)
    assert rel_err(*_both(jop, top, x)) < TOL
    assert rel_err(*_both(jop, top, s, adjoint=True)) < TOL
    assert top.cost(2) == jop.cost(2)


@pytest.mark.parametrize("alpha", [2.0, -0.5, 1.5 - 2j, 3])
def test_scale_matches_reference(alpha, rng):
    d = rand64c(20, rng=rng)
    jop = jit_.Scale(alpha, jit_.Diag(d))
    top = tit.Scale(alpha, Diag(d, device="cpu"))
    x = rand64c(20, 2, rng=rng)
    for adj in (False, True):
        assert rel_err(*_both(jop, top, x, adjoint=adj)) < TOL


def test_scalar_multiplication_gives_scale(rng):
    """``2.0 * op``, ``op * 2.0`` and ``-op`` are Scale operators, as in the
    reference (the port's Operator returned NotImplemented before)."""
    d = rand64c(16, rng=rng)
    op = Diag(d, device="cpu")
    x = torch.from_numpy(rand64c(16, 2, rng=rng))
    for sop, a in ((2.0 * op, 2.0), (op * 2.0, 2.0), (-op, -1.0),
                   ((1 + 1j) * op, 1 + 1j)):
        assert isinstance(sop, tit.Scale)
        assert torch.allclose(sop * x, a * (op * x))
        assert torch.allclose(sop.H * x, np.conj(a) * (op.H * x))
    prod = 0.5 * (op * op)
    assert isinstance(prod, tit.Scale) and isinstance(prod.child, Product)
    with pytest.raises(TypeError):
        True * op
