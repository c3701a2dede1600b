"""Tree-rewriting optimizer for operator expressions.

Counterpart of ``indigo_tpu/transforms.py``. The passes run once on the
host before the solve and keep the semantic rewrites the reference keeps:

  * ``DistributeAdjointOverProduct`` — (AB)^H -> B^H A^H, pushed to leaves.
  * ``DistributeKronIOverProduct``   — KronI(c, AB) -> KronI(c,A) KronI(c,B),
    plus KronI nesting/identity simplifications.
  * ``RealizeMatrices`` — adjacent sparse/diagonal/scalar leaves fused via
    host-side scipy spGEMM into a single leaf; the leaf it builds lands on
    the device of the leaves it replaces.
  * ``Associativity`` — right-leaning product normalization.
  * ``FoldScale`` — scalars hoisted out of products.

Pass classes follow the reference's Visitor/Transform pattern so users can
write their own. A rewritten tree shares the untouched leaves (and their
buffers) with the tree it came from.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .operators import (
    SpMatrix, Diag, Eye, Mask, Product, Adjoint, KronI, BlockDiag, VStack,
    HStack, Scale,
)
from .sparse import bell_to_csr, jag_to_csr, element_to_csr, BlockedJag, \
    ElementELL
from .utils import as_tensor

__all__ = [
    "Visitor", "Transform",
    "DistributeAdjointOverProduct", "DistributeKronIOverProduct",
    "RealizeMatrices", "Associativity", "FoldScale",
    "DEFAULT_RECIPE", "optimize",
]


# KronI(c, M) is realized as one host matrix only up to this many nonzeros
MAX_KRON_NNZ = 50_000_000


def _conj(a):
    """Conjugate of a Scale's scalar or a Diag's payload."""
    if torch.is_tensor(a):
        return a.conj().resolve_conj()  # a stored buffer, not a lazy view
    return np.conj(a).item()


def _host(t):
    return t.detach().cpu().numpy()


def _np_dtype(dt):
    return torch.empty(0, dtype=dt).numpy().dtype


class Visitor:
    """Reference-style visitor: dispatches on node class name."""

    def visit(self, node):
        meth = getattr(self, f"visit_{type(node).__name__}", None)
        if meth is not None:
            return meth(node)
        return self.generic_visit(node)

    def generic_visit(self, node):
        for c in node.children():
            self.visit(c)
        return node


class Transform(Visitor):
    """Bottom-up tree rewriter: children are visited, node is rebuilt."""

    def generic_visit(self, node):
        if isinstance(node, Product):
            return Product(self.visit(node.left), self.visit(node.right))
        if isinstance(node, Adjoint):
            return Adjoint(self.visit(node.child))
        if isinstance(node, KronI):
            return KronI(node.c, self.visit(node.child))
        if isinstance(node, BlockDiag):
            return BlockDiag([self.visit(b) for b in node.blocks])
        if isinstance(node, VStack):
            return VStack([self.visit(b) for b in node.blocks])
        if isinstance(node, HStack):
            return HStack([self.visit(b) for b in node.blocks])
        if isinstance(node, Scale):
            return Scale(node.alpha, self.visit(node.child))
        return node


class DistributeAdjointOverProduct(Transform):
    """(AB)^H -> B^H A^H; push adjoints through all combinators to leaves."""

    def visit_Adjoint(self, node):
        c = node.child
        if isinstance(c, Product):
            return Product(self.visit(Adjoint(c.right)),
                           self.visit(Adjoint(c.left)))
        if isinstance(c, Scale):
            return Scale(_conj(c.alpha), self.visit(Adjoint(c.child)))
        if isinstance(c, KronI):
            return KronI(c.c, self.visit(Adjoint(c.child)))
        if isinstance(c, BlockDiag):
            return BlockDiag([self.visit(Adjoint(b)) for b in c.blocks])
        if isinstance(c, VStack):
            return HStack([self.visit(Adjoint(b)) for b in c.blocks])
        if isinstance(c, HStack):
            return VStack([self.visit(Adjoint(b)) for b in c.blocks])
        if isinstance(c, (Eye, Diag)):
            # Eye is self-adjoint; Diag adjoint is its conjugate diagonal.
            if isinstance(c, Eye):
                return c
            return Diag(_conj(c.payload), name=c._name)
        return Adjoint(self.visit(c))


class DistributeKronIOverProduct(Transform):
    """KronI(c, AB) -> KronI(c,A) KronI(c,B); flatten/elide trivial KronI."""

    def visit_KronI(self, node):
        c, A = node.c, self.visit(node.child)
        if c == 1:
            return A
        if isinstance(A, Product):
            return Product(KronI(c, A.left), KronI(c, A.right))
        if isinstance(A, KronI):
            return KronI(c * A.c, A.child)
        if isinstance(A, Eye):
            return Eye(c * A.shape[0], dtype=A.dtype, device=A.device)
        return KronI(c, A)


class Associativity(Transform):
    """Right-leaning product normalization: (AB)C -> A(BC).

    Flattens the whole factor chain and refolds right — the pairwise
    ``(AB)C -> A(BC)`` rewrite alone can leave left-nested products when
    the hoisted middle factor is itself a product, which hides leaf
    adjacencies from RealizeMatrices.
    """

    def visit_Product(self, node):
        factors = []

        def collect(n):
            if isinstance(n, Product):
                collect(n.left)
                collect(n.right)
            else:
                factors.append(self.visit(n))

        collect(node)
        out = factors[-1]
        for f in reversed(factors[:-1]):
            out = Product(f, out)
        return out


class FoldScale(Transform):
    """Hoist scalars out of products: (aA)(bB) -> (ab)(AB); drop Scale(1)."""

    def visit_Product(self, node):
        left = self.visit(node.left)
        right = self.visit(node.right)
        alpha = None
        if isinstance(left, Scale):
            alpha = np.asarray(left.alpha)
            left = left.child
        if isinstance(right, Scale):
            ra = np.asarray(right.alpha)
            alpha = ra if alpha is None else alpha * ra
            right = right.child
        prod = Product(left, right)
        return prod if alpha is None else Scale(alpha.item(), prod)

    def visit_Scale(self, node):
        child = self.visit(node.child)
        a = np.asarray(node.alpha)
        if isinstance(child, Scale):
            a = a * np.asarray(child.alpha)
            child = child.child
        if a.ndim == 0 and a == 1:
            return child
        return Scale(a.item(), child)


def _to_scipy(node):
    """Materialize a node as a host scipy sparse matrix, or None.

    Only cheap/structured leaves are materialized: SpMatrix, Diag, Eye,
    Scale/Adjoint thereof. Dense and FFT leaves are never realized.
    """
    if isinstance(node, SpMatrix):
        if isinstance(node.ell, BlockedJag):
            return jag_to_csr(node.ell)
        if isinstance(node.ell, ElementELL):
            return element_to_csr(node.ell)
        return bell_to_csr(node.ell)
    if isinstance(node, Diag):
        return sp.diags(_host(node.payload)).tocsr()
    if isinstance(node, Eye):
        return sp.identity(node.shape[0], dtype=_np_dtype(node.dtype)).tocsr()
    if isinstance(node, Scale):
        m = _to_scipy(node.child)
        if m is None:
            return None
        alpha = np.asarray(node.alpha)
        if alpha.ndim != 0:
            return None
        return (complex(alpha) * m).tocsr()
    if isinstance(node, Adjoint):
        m = _to_scipy(node.child)
        return None if m is None else m.conj().T.tocsr()
    if isinstance(node, Mask):
        keep = _host(node.keep)
        m, n = node.shape
        return sp.csr_matrix(
            (np.ones(len(keep), _np_dtype(node.dtype)),
             keep, np.arange(len(keep) + 1)), shape=(m, n))
    if isinstance(node, KronI):
        # Only structured children (Mask/Diag/Eye and wrappers): realizing
        # KronI(SpMatrix) would trade the batched SpMM for one big CSR and
        # lose the structural batching. The case this serves is
        # KronI(Mask)^H . KronI(Mask) -> Diag (see RealizeMatrices).
        def structured(c):
            if isinstance(c, (Mask, Diag, Eye)):
                return True
            if isinstance(c, (Scale, Adjoint)):
                return structured(c.child)
            return False
        if not structured(node.child):
            return None
        m = _to_scipy(node.child)
        if m is None or node.c * m.nnz > MAX_KRON_NNZ:
            return None
        return sp.kron(sp.identity(node.c, dtype=m.dtype), m).tocsr()
    return None


def _from_scipy(m, like_dtype, device=None):
    """Build the cheapest leaf representing a host scipy matrix, on
    ``device``: the device of the tree it replaces (None: that tree holds
    no arrays, and the leaf goes to the card, as a numpy operand of such a
    tree would)."""
    m = m.tocsr()
    M, N = m.shape
    npdt = _np_dtype(like_dtype)
    if M == N:
        d = m.diagonal()
        if m.nnz == np.count_nonzero(d) and (m - sp.diags(d)).nnz == 0:
            if np.allclose(d, 1):
                return Eye(N, dtype=like_dtype, device=device)
            # the tree's own dtype, which may be 64-bit if its tensors are
            return Diag(as_tensor(d, device, dtype=like_dtype))
    return SpMatrix(m.astype(npdt), device=device)


def _device(*nodes):
    """Device of the first array found in the given trees, else None."""
    for n in nodes:
        if n.device is not None:
            return n.device
    return None


class RealizeMatrices(Transform):
    """Fuse adjacent materializable leaves in a Product via host spGEMM:
    the pass that decides which fused matrix the hot path applies."""

    def visit_Product(self, node):
        left = self.visit(node.left)
        right = self.visit(node.right)
        lm = _to_scipy(left)
        rm = _to_scipy(right)
        if lm is not None and rm is not None:
            fused = (lm @ rm).tocsr()
            dtype = torch.promote_types(left.dtype, right.dtype)
            return _from_scipy(fused, dtype, _device(left, right))
        # A @ (B @ C) with A, B materializable (right-leaning trees).
        if lm is not None and isinstance(right, Product):
            rlm = _to_scipy(right.left)
            if rlm is not None:
                dtype = torch.promote_types(left.dtype, right.left.dtype)
                fused = _from_scipy((lm @ rlm).tocsr(), dtype,
                                    _device(left, right.left))
                return Product(fused, right.right)
        if isinstance(left, Eye):
            return right
        if isinstance(right, Eye):
            return left
        return Product(left, right)


DEFAULT_RECIPE = (
    DistributeAdjointOverProduct,
    DistributeKronIOverProduct,
    Associativity,
    FoldScale,
    RealizeMatrices,
    Associativity,
)


def optimize(tree, recipe=None):
    """Apply the default (or given) pass pipeline to an operator tree."""
    for Pass in (recipe or DEFAULT_RECIPE):
        tree = Pass().visit(tree)
    return tree
