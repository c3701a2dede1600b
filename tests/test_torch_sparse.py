"""Block-sparse formats and plain SpMMs: the port vs the reference.

Layouts must be array-equal to the reference's (same converters, same
``auto_bm`` rule). The plain torch SpMMs are held to the reference's
Pallas kernels run in interpret mode, its jnp paths and scipy at 1e-5,
the reference's own Pallas-vs-scipy bar (f32 sums in another order).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from indigo_tpu import sparse as jsp
from indigo_tpu.cplx import to_numpy
from indigo_tpu.ops.ell_spmm import ell_spmm_pallas, jag_spmm_pallas
from indigo_tpu.utils import randM
from indigo_tpu_torch import sparse as tsp
from indigo_tpu_torch.convert import sparse_from_reference
from indigo_tpu_torch.ops import spmm
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 1e-5
SHAPES = [(64, 256, 8, 0.05), (100, 300, 4, 0.02), (257, 640, 16, 0.01),
          (40, 1000, 8, 0.001)]


def _eq(t, ref):
    np.testing.assert_array_equal(t.numpy(), to_numpy(ref))


@pytest.mark.parametrize("m,n,density", [
    (8, 128, 0.5), (100, 300, 0.05), (257, 129, 0.02), (64, 64, 0.0)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_jag_layout_equals_reference(m, n, density, dtype, rng):
    A = randM(m, n, density, rng=rng, dtype=dtype) if density else \
        sp.csr_matrix((m, n), dtype=dtype)
    j, t = jsp.csr_to_jag(A), tsp.csr_to_jag(A)
    _eq(t.data, j.data)
    _eq(t.bcols, j.bcols)
    _eq(t.brows, j.brows)
    assert (t.shape, t.nnz, t.bm) == (j.shape, j.nnz, j.bm)
    assert abs(tsp.jag_to_csr(t) - A).max() < 1e-6 if A.nnz else \
        tsp.jag_to_csr(t).nnz == 0


@pytest.mark.parametrize("m,n,density", [
    (8, 128, 0.5), (100, 300, 0.05), (257, 129, 0.02), (64, 64, 0.0)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_bell_layout_equals_reference(m, n, density, dtype, rng):
    A = randM(m, n, density, rng=rng, dtype=dtype) if density else \
        sp.csr_matrix((m, n), dtype=dtype)
    j, t = jsp.csr_to_bell(A), tsp.csr_to_bell(A)
    _eq(t.data, j.data)
    _eq(t.cols, j.cols)
    assert (t.shape, t.nnz) == (j.shape, j.nnz)
    assert abs(tsp.bell_to_csr(t) - A).max() < 1e-6 if A.nnz else \
        tsp.bell_to_csr(t).nnz == 0


@pytest.mark.parametrize("adjoint_segments", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_element_layout_and_spmm(adjoint_segments, dtype, rng):
    A = randM(80, 500, 0.01, rng=rng, dtype=dtype)
    j = jsp.csr_to_element(A, adjoint_segments=adjoint_segments)
    t = tsp.csr_to_element(A, adjoint_segments=adjoint_segments)
    _eq(t.data, j.data)
    _eq(t.cols, j.cols)
    if adjoint_segments:
        for name in ("adj_rows", "adj_vals", "adj_segs"):
            _eq(getattr(t, name), getattr(j, name))
    else:
        assert t.adj_segs is None
    assert abs(tsp.element_to_csr(t) - A).max() < 1e-6
    x = rand64c(500, 3, rng=rng)
    s = rand64c(80, 3, rng=rng)
    y = tsp.element_spmm(t, torch.from_numpy(x))
    ya = tsp.element_spmm(t, torch.from_numpy(s), adjoint=True)
    assert rel_err(y, np.asarray(jsp.element_spmm(j, x))) < TOL
    assert rel_err(ya, np.asarray(jsp.element_spmm(j, s, adjoint=True))) \
        < TOL
    assert rel_err(y, A @ x) < TOL
    assert rel_err(ya, A.conj().T @ s) < TOL


def test_auto_bm_growth_equals_reference(rng):
    """A tall matrix and a tiny index budget: bm grows the same way."""
    A = randM(6000, 1024, 0.002, rng=rng, dtype=np.float32)
    j = jsp.csr_to_jag(A, smem_budget=2 * 1024)
    t = tsp.csr_to_jag(A, smem_budget=2 * 1024)
    assert t.bm == j.bm > 8
    _eq(t.data, j.data)
    _eq(t.brows, j.brows)
    x = np.ones((1024, 2), np.float32)
    assert rel_err(tsp.jag_spmm(t, torch.from_numpy(x)), A @ x) < TOL


@pytest.mark.parametrize("m,n,k,density", SHAPES)
def test_jag_spmm_vs_pallas_interpret(m, n, k, density, rng):
    A = randM(m, n, density, rng=rng, dtype=np.float32)
    x = rng.standard_normal((n, k), dtype=np.float32)
    ref = np.asarray(jag_spmm_pallas(jsp.csr_to_jag(A), x, interpret=True))
    y = tsp.jag_spmm(tsp.csr_to_jag(A), torch.from_numpy(x))
    assert rel_err(y, ref) < TOL
    assert rel_err(y, A @ x) < TOL


@pytest.mark.parametrize("m,n,k,density", SHAPES[:3] + [(8, 128, 128, 0.5)])
def test_bell_spmm_vs_pallas_interpret(m, n, k, density, rng):
    A = randM(m, n, density, rng=rng, dtype=np.float32)
    x = rng.standard_normal((n, k), dtype=np.float32)
    ref = np.asarray(ell_spmm_pallas(jsp.csr_to_bell(A), x, interpret=True))
    y = tsp.bell_spmm(tsp.csr_to_bell(A), torch.from_numpy(x))
    assert rel_err(y, ref) < TOL
    assert rel_err(y, A @ x) < TOL


@pytest.mark.parametrize("fmt", ["jag", "bell"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("m,n,k", [(100, 300, 1), (300, 100, 7), (8, 8, 3)])
def test_plain_spmm_vs_jnp(fmt, dtype, m, n, k, rng):
    """Forward and adjoint (through the separately tiled A^H)."""
    A = randM(m, n, 0.05, rng=rng, dtype=dtype)
    conv_j = jsp.csr_to_jag if fmt == "jag" else jsp.csr_to_bell
    conv_t = tsp.csr_to_jag if fmt == "jag" else tsp.csr_to_bell
    jfn = jsp.jag_spmm if fmt == "jag" else jsp.bell_spmm
    for M_ in (A, A.conj().T.tocsr()):
        x = rand64c(M_.shape[1], k, rng=rng)
        y = spmm(conv_t(M_), torch.from_numpy(x))
        assert rel_err(y, np.asarray(jfn(conv_j(M_), x))) < TOL
        assert rel_err(y, M_ @ x) < TOL


def test_empty_block_rows_exactly_zero(rng):
    A = sp.csr_matrix((np.ones(1, np.float32), ([17], [5])), shape=(64, 256))
    x = torch.from_numpy(rng.standard_normal((256, 4), dtype=np.float32))
    for conv, fn in ((tsp.csr_to_jag, tsp.jag_spmm),
                     (tsp.csr_to_bell, tsp.bell_spmm)):
        y = fn(conv(A), x).numpy()
        assert (y[0:16] == 0).all() and (y[18:] == 0).all()
        np.testing.assert_array_equal(y[17], x[5].numpy())


def test_complex_fold_matches_reference_dispatch(rng):
    """Complex x against a real matrix through ``view_as_real`` (no
    [Re | Im] copy) gives the reference's complex result."""
    from indigo_tpu.ops import spmm as jspmm

    A = randM(60, 200, 0.05, rng=rng, dtype=np.float32)
    x = rand64c(200, 3, rng=rng)
    xt = torch.from_numpy(x)
    folded = torch.view_as_real(xt).reshape(200, 6)
    for conv_t, conv_j in ((tsp.csr_to_jag, jsp.csr_to_jag),
                           (tsp.csr_to_bell, jsp.csr_to_bell)):
        yt = spmm(conv_t(A), folded)
        y = torch.view_as_complex(yt.reshape(60, 3, 2))
        assert rel_err(y, np.asarray(jspmm(conv_j(A), x))) < TOL
        assert rel_err(y, spmm(conv_t(A), xt)) < 1e-6


@pytest.mark.parametrize("m,n,density", [(257, 640, 0.01),
                                         (40, 1000, 0.001), (64, 64, 0.0)])
def test_bptr_consistent_with_brows(m, n, density, rng):
    A = randM(m, n, density, rng=rng, dtype=np.float32) if density else \
        sp.csr_matrix((m, n), dtype=np.float32)
    t = tsp.csr_to_jag(A)
    bptr, brows = t.bptr.numpy(), t.brows.numpy()
    assert bptr.dtype == np.int32 and bptr.shape == (t.R + 1,)
    assert bptr[0] == 0 and bptr[-1] == t.NB
    for r in range(t.R):
        run = brows[bptr[r]:bptr[r + 1]]
        assert len(run) >= 1 and (run == r).all()


def test_sparse_from_reference_round_trip(rng):
    A = randM(100, 300, 0.05, rng=rng, dtype=np.complex64)
    for conv_j, conv_t in ((jsp.csr_to_jag, tsp.csr_to_jag),
                           (jsp.csr_to_bell, tsp.csr_to_bell),
                           (jsp.csr_to_element, tsp.csr_to_element)):
        got, want = sparse_from_reference(conv_j(A), device="cpu"), conv_t(A)
        assert type(got) is type(want)
        for (name, a), (_, b) in zip(got.named_buffers(),
                                     want.named_buffers()):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), name)


def test_estimate_jag_bytes_equals_reference(rng):
    for A in (randM(300, 700, 0.01, rng=rng, dtype=np.float32),
              randM(40, 1000, 0.001, rng=rng, dtype=np.complex64)):
        for bm in (8, 16):
            assert tsp.estimate_jag_bytes(A, bm) == \
                jsp.estimate_jag_bytes(A, bm)
