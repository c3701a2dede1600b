"""The operator algebra: every leaf and combinator of the port against the
reference on the same arrays (``convert.operator_from_reference``), the
introspection surface, and the coexistence with ``nn.Module``.

Tolerance 1e-5 for every forward and adjoint apply (f32 operator level, the
reference's own bar against its oracles); exact for pure data movement.
"""
import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu.utils import randM
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 1e-5


def _leaf(kind, rng):
    """A reference operator of the given kind, from the seeded rng."""
    if kind == "fft1":
        return jit_.UnscaledFFT((12,))
    if kind == "fft2":
        return jit_.UnscaledFFT((6, 10))
    if kind == "fft3":
        return jit_.UnscaledFFT((4, 6, 8))
    if kind == "croppad2":
        return jit_.CropPad((5, 6), (8, 9))
    if kind == "croppad3":
        return jit_.CropPad((3, 4, 5), (6, 4, 8))
    if kind == "mask":
        return jit_.Mask(rng.permutation(20)[:9], 20)
    if kind == "mask_bool":
        return jit_.Mask.from_bool(rng.random((4, 6)) < 0.5)
    if kind == "eye":
        return jit_.Eye(7)
    if kind == "one":
        return jit_.One((5, 8))
    if kind == "dense":
        return jit_.DenseMatrix(rand64c(6, 9, rng=rng))
    if kind == "dense_real":
        return jit_.DenseMatrix(
            rng.standard_normal((6, 9)).astype(np.float32))
    if kind == "diag":
        return jit_.Diag(rand64c(9, rng=rng))
    if kind == "perm":
        return jit_.Perm(rng.permutation(11))
    if kind == "spmatrix":
        return jit_.SpMatrix(randM(10, 12, 0.3, rng=rng))
    A = jit_.DenseMatrix(rand64c(4, 5, rng=rng))
    B = jit_.DenseMatrix(rand64c(6, 5, rng=rng))
    C = jit_.DenseMatrix(rand64c(4, 7, rng=rng))
    D = jit_.Diag(rand64c(5, rng=rng))
    return {
        "blockdiag": lambda: jit_.BlockDiag([A, B, D]),
        "hstack": lambda: jit_.HStack([A, C]),
        "vstack": lambda: jit_.VStack([A, B]),
        "scale": lambda: (2.0 - 0.5j) * A,
        "kroni": lambda: jit_.KronI(3, A),
        "adjoint": lambda: A.H,
        "product": lambda: B * D * A.H * C,
    }[kind]()


KINDS = ["fft1", "fft2", "fft3", "croppad2", "croppad3", "mask", "mask_bool",
         "eye", "one", "dense", "dense_real", "diag", "perm", "spmatrix",
         "blockdiag", "hstack", "vstack", "scale", "kroni", "adjoint",
         "product"]


@pytest.mark.parametrize("kind", KINDS)
def test_operator_matches_reference(rng, kind):
    ref = _leaf(kind, rng)
    op = operator_from_reference(ref, device="cpu")
    assert type(op).__name__ == type(ref).__name__
    assert op.shape == tuple(ref.shape)
    x = rand64c(ref.shape[1], 3, rng=rng)
    y = rand64c(ref.shape[0], 3, rng=rng)
    assert rel_err(op * torch.from_numpy(x), np.asarray(ref * x)) < TOL
    assert rel_err(op.H * torch.from_numpy(y), np.asarray(ref.H * y)) < TOL
    # 1-D operand, as the reference takes it
    assert rel_err(op * torch.from_numpy(x[:, 0]),
                   np.asarray(ref * x[:, 0])) < TOL
    f, b = op.cost(2)
    assert f >= 0 and b >= 0


def test_own_constructors_match_reference(rng):
    """The port's constructors take the reference's arguments."""
    keep = rng.permutation(30)[:12]
    d = rand64c(30, rng=rng)
    M = rand64c(12, 12, rng=rng)
    ref = (jit_.DenseMatrix(M) * jit_.Mask(keep, 30)
           * jit_.UnscaledFFT((5, 6), dtype=np.complex64) * jit_.Diag(d)
           * jit_.CropPad((4, 5), (5, 6), dtype=np.complex64).H.H)
    op = (tit.DenseMatrix(M, device="cpu") * tit.Mask(keep, 30, device="cpu")
          * tit.UnscaledFFT((5, 6), dtype=np.complex64, device="cpu")
          * tit.Diag(d, device="cpu")
          * tit.CropPad((4, 5), (5, 6), dtype=np.complex64, device="cpu").H.H)
    x = rand64c(20, 2, rng=rng)
    y = rand64c(12, 2, rng=rng)
    assert rel_err(op * x, np.asarray(ref * x)) < TOL
    assert rel_err(op.H * y, np.asarray(ref.H * y)) < TOL


def test_unscaled_fft_normal_is_n_times_identity(rng):
    F = tit.UnscaledFFT((4, 6), device="cpu")
    x = torch.from_numpy(rand64c(24, 2, rng=rng))
    assert rel_err(F.H * (F * x), 24 * x) < TOL


def test_mask_adjoint_zero_fills_and_rejects_duplicates(rng):
    keep = np.array([7, 2, 5])
    P = tit.Mask(keep, 9, device="cpu")
    y = torch.from_numpy(rand64c(3, 2, rng=rng))
    full = P.H * y
    assert torch.equal(full[keep], y)
    rest = np.setdiff1d(np.arange(9), keep)
    assert torch.count_nonzero(full[rest]) == 0
    with pytest.raises(ValueError):
        tit.Mask([1, 1, 2], 5, device="cpu")
    with pytest.raises(ValueError):
        tit.Mask([1, 9], 5, device="cpu")


def test_adjoint_of_adjoint_unwraps(rng):
    A = tit.DenseMatrix(rand64c(3, 4, rng=rng), device="cpu")
    assert A.H.H is A
    assert tit.Adjoint(tit.Adjoint(A)) is A
    B = copy.deepcopy(A.H)      # an Adjoint must survive a deep copy
    assert isinstance(B, tit.Adjoint) and B.shape == (4, 3)


def _sense_like(rng):
    """Reference tree with an SpMatrix, a stack and a KronI."""
    n = 8
    P = jit_.SpMatrix(randM(5, n, 0.4, rng=rng, dtype=np.float32))
    core = P * jit_.UnscaledFFT((n,))
    coils = jit_.VStack([jit_.Diag(rand64c(n, rng=rng)) for _ in range(2)])
    return jit_.KronI(2, core) * coils


def test_to_dense_dump_memusage_eval(rng):
    ref = _sense_like(rng)
    op = operator_from_reference(ref, device="cpu")
    assert rel_err(op.to_dense(), np.asarray(ref.to_dense())) < TOL
    # the same tree, node for node: names and shapes of every line
    strip = lambda s: [ln.split(">")[0] for ln in s.splitlines()]  # noqa
    assert strip(op.dump()) == strip(ref.dump())
    # memusage counts every buffer of the tree once
    assert op.memusage() == sum(b.numel() * b.element_size()
                                for b in op.buffers())
    d = (tit.Diag(rand64c(6, rng=rng), device="cpu")
         * tit.DenseMatrix(rand64c(6, 4, rng=rng), device="cpu"))
    assert d.memusage() == 8 * (6 + 24)
    x = rand64c(ref.shape[1], 2, rng=rng)
    y = rand64c(ref.shape[0], 2, rng=rng)
    out = op.eval(x, alpha=2.0, beta=-0.5, y=y)
    assert rel_err(out, np.asarray(ref.eval(x, alpha=2.0, beta=-0.5, y=y))) \
        < TOL
    back = op.eval(y, alpha=0.5, forward=False)
    assert rel_err(back, np.asarray(ref.eval(y, alpha=0.5, forward=False))) \
        < TOL


def test_dtype_follows_reference(rng):
    ref = _sense_like(rng)
    op = operator_from_reference(ref, device="cpu")

    def walk(a, b):
        assert str(a.dtype).replace("torch.", "") == np.dtype(b.dtype).name
        for ca, cb in zip(a.children(), b.children()):
            walk(ca, cb)
    walk(op, ref)


def test_module_surface_on_a_tree_with_spmatrix(rng):
    """children() is the operator meaning; .to(), .train(), .eval() and
    state_dict() still reach every registered sub-module, the SpMatrix's
    sparse formats included."""
    op = operator_from_reference(_sense_like(rng), device="cpu")
    kinds = [type(c).__name__ for c in op.children()]
    assert kinds == ["KronI", "VStack"]
    sp_leaf = op.left.child.left
    assert isinstance(sp_leaf, tit.SpMatrix) and sp_leaf.children() == ()
    assert all(isinstance(c, tit.Operator)
               for m in op.modules() if isinstance(m, tit.Operator)
               for c in m.children())
    # .to()/_apply reaches the formats: their f32 tiles follow .double()
    assert sp_leaf.ell.data.dtype == torch.float32
    op.double()
    assert sp_leaf.ell.data.dtype == torch.float64
    assert sp_leaf.ellH.data.dtype == torch.float64
    op.float()
    assert sp_leaf.ell.data.dtype == torch.float32
    assert op.to("cpu") is op
    # eval() with no operand is nn.Module.eval(); train() undoes it
    assert op.eval() is op
    assert not any(m.training for m in op.modules())
    assert op.train() is op
    assert all(m.training for m in op.modules())
    # state_dict sees leaves, stack blocks and the formats' buffers
    keys = set(op.state_dict())
    assert "right.blocks.0.d" in keys
    assert any(k.startswith("left.child.left._ell.") for k in keys)
    fresh = operator_from_reference(_sense_like(np.random.default_rng(5)),
                                    device="cpu")
    x = torch.from_numpy(rand64c(op.shape[1], 1, rng=rng))
    assert rel_err(fresh * x, op * x) > 1e-2
    fresh.load_state_dict(op.state_dict())
    assert rel_err(fresh * x, op * x) < 1e-6
    both = copy.deepcopy(op)
    assert rel_err(both * x, op * x) == 0.0


def test_scipy_csr_roundtrip_of_zpad(rng):
    """noncart.zpad_mat is CropPad as a matrix, array-equal to the
    reference's."""
    from indigo_tpu import noncart as jn
    from indigo_tpu_torch import noncart as tn
    a, b = tn.zpad_mat((4, 5), (6, 8)), jn.zpad_mat((4, 5), (6, 8))
    assert (a != b).nnz == 0 and a.dtype == b.dtype
    Z = tit.CropPad((4, 5), (6, 8), device="cpu")
    x = rand64c(20, 2, rng=rng)
    assert rel_err(Z * x, sp.csr_matrix(a) @ x) == 0.0
