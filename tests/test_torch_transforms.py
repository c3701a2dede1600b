"""The tree optimizer of the port: the reference's transform tests
(tests/test_transforms.py) on the port's passes at the same 2e-5 bar, and
the port's ``optimize`` against the reference's on the same input tree (same
tree of class names, same result to 2e-5).
"""
import numpy as np
import pytest

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu import transforms as jtr
from indigo_tpu.utils import randM
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch.operators import (Adjoint, Diag, Eye, KronI, Product,
                                        Scale, SpMatrix)
from indigo_tpu_torch.transforms import (
    DEFAULT_RECIPE, Associativity, DistributeAdjointOverProduct,
    DistributeKronIOverProduct, FoldScale, RealizeMatrices, Transform,
    Visitor, optimize)
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 2e-5


def assert_equiv(a, b, rng, tol=TOL):
    assert a.shape == b.shape
    x = rand64c(a.shape[1], 2, rng=rng)
    assert rel_err(a * x, b * x) < tol
    y = rand64c(a.shape[0], 2, rng=rng)
    assert rel_err(a.H * y, b.H * y) < tol


def dense(rng, m, n):
    return tit.DenseMatrix(rand64c(m, n, rng=rng), device="cpu")


def test_distribute_adjoint(rng):
    A = dense(rng, 6, 8)
    B = tit.SpMatrix(randM(8, 10, 0.3, rng=rng), device="cpu")
    tree = (A * B).H
    out = DistributeAdjointOverProduct().visit(tree)
    assert isinstance(out, Product)
    assert_equiv(tree, out, rng)

    def no_adj_of_combinator(n):
        if isinstance(n, Adjoint):
            assert not isinstance(n.child, (Product, KronI))
        for c in n.children():
            no_adj_of_combinator(c)
    no_adj_of_combinator(out)


def test_distribute_adjoint_through_stacks_and_scale(rng):
    A, B = dense(rng, 4, 5), dense(rng, 6, 5)
    d = tit.Diag(rand64c(5, rng=rng), device="cpu")
    tree = ((2.0 + 1.0j) * (tit.VStack([A, B]) * d
                            * tit.HStack([d, tit.Eye(5, device="cpu")]))).H
    out = DistributeAdjointOverProduct().visit(tree)
    assert_equiv(tree, out, rng)
    kinds = {type(m).__name__ for m in out.modules()}
    assert "HStack" in kinds and "VStack" in kinds
    bd = tit.BlockDiag([A, B]).H
    assert_equiv(bd, DistributeAdjointOverProduct().visit(bd), rng)


def test_distribute_kroni(rng):
    A, B = dense(rng, 4, 5), dense(rng, 5, 6)
    tree = KronI(3, A * B)
    out = DistributeKronIOverProduct().visit(tree)
    assert isinstance(out, Product)
    assert_equiv(tree, out, rng)
    nested = KronI(2, KronI(3, A))
    flat = DistributeKronIOverProduct().visit(nested)
    assert isinstance(flat, KronI) and flat.c == 6
    assert_equiv(nested, flat, rng)
    assert DistributeKronIOverProduct().visit(KronI(1, A)) is A
    eye = DistributeKronIOverProduct().visit(KronI(3, Eye(4, device="cpu")))
    assert isinstance(eye, Eye) and eye.shape == (12, 12)


def test_associativity(rng):
    A, B, C = dense(rng, 4, 5), dense(rng, 5, 6), dense(rng, 6, 7)
    tree = (A * B) * C
    out = Associativity().visit(tree)
    assert isinstance(out, Product) and not isinstance(out.left, Product)
    assert_equiv(tree, out, rng)


def test_fold_scale(rng):
    A, B = dense(rng, 5, 5), dense(rng, 5, 5)
    tree = (2.0 * A) * (3.0 * B)
    out = FoldScale().visit(tree)
    assert_equiv(tree, out, rng)
    assert isinstance(out, Scale) and out.alpha == 6.0
    assert not isinstance(out.child.left, Scale)
    assert FoldScale().visit(Scale(1.0, A)) is A
    two = FoldScale().visit(Scale(2.0, Scale(0.25j, A)))
    assert isinstance(two, Scale) and two.alpha == 0.5j and two.child is A


def test_realize_matrices(rng):
    S1 = tit.SpMatrix(randM(10, 12, 0.3, rng=rng), device="cpu")
    S2 = tit.SpMatrix(randM(12, 9, 0.3, rng=rng), device="cpu")
    tree = S1 * S2
    out = RealizeMatrices().visit(tree)
    assert isinstance(out, SpMatrix)
    assert_equiv(tree, out, rng)


@pytest.mark.parametrize("fmt", ["jag", "bell", "element"])
def test_realize_reads_every_sparse_format(rng, fmt):
    S = tit.SpMatrix(randM(10, 12, 0.3, rng=rng), format=fmt, device="cpu")
    d = tit.Diag(rand64c(10, rng=rng), device="cpu")
    out = RealizeMatrices().visit(d * S)
    assert isinstance(out, SpMatrix)
    assert_equiv(d * S, out, rng)


def test_realize_through_chain(rng):
    """Diag * Sp * FFT: the two left leaves fuse, FFT stays."""
    d = tit.Diag(rand64c(12, rng=rng), device="cpu")
    S = tit.SpMatrix(randM(12, 12, 0.3, rng=rng), device="cpu")
    F = tit.UnscaledFFT((12,), device="cpu")
    tree = d * (S * F)
    out = RealizeMatrices().visit(tree)
    assert isinstance(out, Product)
    assert isinstance(out.left, SpMatrix)
    assert out.left.shape == (12, 12)
    assert_equiv(tree, out, rng)


def test_realize_eye_elision_and_diag(rng):
    A = dense(rng, 6, 6)
    tree = Product(Eye(6, device="cpu"), A)
    out = RealizeMatrices().visit(tree)
    assert out is A
    assert_equiv(tree, out, rng)
    # two diagonals fuse into one Diag; a diagonal and its inverse into Eye
    d = rand64c(6, rng=rng)
    dd = RealizeMatrices().visit(tit.Diag(d, device="cpu")
                                 * tit.Diag(d, device="cpu"))
    assert isinstance(dd, Diag)
    assert rel_err(dd.payload, d * d) < 1e-6
    one = RealizeMatrices().visit(tit.Diag(d, device="cpu")
                                  * tit.Diag(1 / d, device="cpu"))
    assert isinstance(one, Eye)


def test_full_optimize_pipeline(rng):
    """A realistic SENSE-like tree survives the full default recipe."""
    n = 8
    F = tit.UnscaledFFT((n,), device="cpu")
    P = tit.SpMatrix(randM(5, n, 0.4, rng=rng), device="cpu")
    S = tit.Diag(rand64c(n, rng=rng), device="cpu")
    A = KronI(2, P * F * S)
    AH_A = A.H * A
    assert_equiv(AH_A, optimize(AH_A), rng)
    assert_equiv(A, A.optimize(), rng)
    assert_equiv(A, optimize(A, recipe=DEFAULT_RECIPE[:3]), rng)


def test_associativity_deep_right_lean(rng):
    ops = [dense(rng, 6, 6) for _ in range(5)]
    tree = Product(Product(ops[0], Product(ops[1], ops[2])),
                   Product(ops[3], ops[4]))
    out = Associativity().visit(tree)

    def check(n):
        if isinstance(n, Product):
            assert not isinstance(n.left, Product)
            check(n.right)
    check(out)
    assert_equiv(tree, out, rng)


def _leaf_kinds(node):
    return {type(m).__name__ for m in node.modules()
            if isinstance(m, tit.Operator) and not m.children()}


def _cartesian(rng, n=8, nc=2):
    mask = np.zeros((n, n), bool)
    mask[rng.random((n, n)) < 0.5] = True
    mask[3:5] = True
    return mask, rand64c(nc, n, n, rng=rng)


def test_mask_normal_fuses_to_diag(rng):
    """optimize(A.H A) on a Cartesian SENSE tree fuses Mask.H . Mask into a
    0/1 Diag: no gather leaf survives in the normal-op hot loop."""
    from indigo_tpu_torch.models import cartesian_sense_op
    mask, maps = _cartesian(rng)
    A = cartesian_sense_op(mask, maps, device="cpu")
    AHA = A.H * A
    opt = optimize(AHA)
    kinds = _leaf_kinds(opt)
    assert "Mask" not in kinds and "SpMatrix" not in kinds, kinds
    assert_equiv(AHA, opt, rng)
    fused = [m for m in opt.modules() if isinstance(m, Diag)
             and m.shape[0] == 2 * 64]
    assert len(fused) == 1
    vals = set(np.unique(fused[0].payload.real.numpy()))
    assert vals <= {0.0, 1.0}


def test_kroni_nnz_cap_leaves_the_mask(rng, monkeypatch):
    """Over the nonzero cap KronI(Mask) is not realized, as in the
    reference; the tree stays correct with its Mask leaves."""
    from indigo_tpu_torch import transforms as ttr
    from indigo_tpu_torch.models import cartesian_sense_op
    assert ttr.MAX_KRON_NNZ == 50_000_000
    mask, maps = _cartesian(rng)
    A = cartesian_sense_op(mask, maps, device="cpu")
    AHA = A.H * A
    monkeypatch.setattr(ttr, "MAX_KRON_NNZ", 2 * int(mask.sum()) - 1)
    opt = optimize(AHA)
    assert "Mask" in _leaf_kinds(opt)
    assert_equiv(AHA, opt, rng)


def _names(node):
    return (type(node).__name__,) + tuple(_names(c) for c in node.children())


def _reference_trees(rng):
    from indigo_tpu.models import cartesian_sense_op
    n = 8
    F = jit_.UnscaledFFT((n,))
    P = jit_.SpMatrix(randM(5, n, 0.4, rng=rng))
    S = jit_.Diag(rand64c(n, rng=rng))
    A = jit_.KronI(2, P * F * S)
    mask, maps = _cartesian(rng)
    C = cartesian_sense_op(mask, maps)
    Pr = jit_.SpMatrix(randM(6, n, 0.4, rng=rng, dtype=np.float32))
    E = Pr * F * jit_.Diag(rand64c(n, rng=rng))
    D = jit_.DenseMatrix(rand64c(n, n, rng=rng))
    return {
        "kron_sense": A, "kron_sense_normal": A.H * A,
        "cartesian": C, "cartesian_normal": C.H * C,
        "example_recipe": E, "example_recipe_normal": E.H * E,
        "scaled": (2.0 * D) * (3.0 * jit_.Eye(n)) * (D * D).H,
        "stacks": (jit_.VStack([D, S]) * jit_.HStack([S, D])).H,
    }


@pytest.mark.parametrize("case", sorted(_reference_trees(
    np.random.default_rng(0))))
def test_optimize_gives_the_reference_tree(rng, case):
    """Same input tree, same rewritten tree (class names node for node) and
    the same operator to 2e-5."""
    ref = _reference_trees(rng)[case]
    port = operator_from_reference(ref, device="cpu")
    assert _names(port) == _names(ref)
    ref_opt, port_opt = jtr.optimize(ref), optimize(port)
    assert _names(port_opt) == _names(ref_opt)
    x = rand64c(ref.shape[1], 2, rng=rng)
    y = rand64c(ref.shape[0], 2, rng=rng)
    assert rel_err(port_opt * x, np.asarray(ref_opt * x)) < TOL
    assert rel_err(port_opt.H * y, np.asarray(ref_opt.H * y)) < TOL


def test_visitor_and_user_pass(rng):
    """The Visitor/Transform pattern is open to user passes."""
    A, B = dense(rng, 4, 4), dense(rng, 4, 4)
    seen = []

    class Count(Visitor):
        def visit_DenseMatrix(self, node):
            seen.append(node)
            return node
    Count().visit((A * B).H * tit.KronI(1, A))
    assert len(seen) == 3

    class DropScale(Transform):
        def visit_Scale(self, node):
            return self.visit(node.child)
    out = DropScale().visit(2.0 * (A * (3.0 * B)))
    assert_equiv(out, A * B, rng)
