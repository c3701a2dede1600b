"""The row form of the block-sparse formats: what kernels K3/K4 read.

A real BlockedJag / BlockedELL derives, from its own tiles, the CSR of its
stored nonzeros (``row_ptr``, ``nz_col``, ``nz_val``) and the list of rows
the kernel splits (``heavy_rows``). These tests hold it array-equal to the
format's own ``jag_to_csr`` / ``bell_to_csr`` (a separate path through every
stored entry), to the row form of a format carried over from the reference,
and its product to the plain SpMMs at 1e-6 (f32 sums in another order).
"""
import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from indigo_tpu import sparse as jsp
from indigo_tpu_torch import sparse as tsp
from indigo_tpu_torch.convert import sparse_from_reference
from indigo_tpu_torch.ops import spmm
from indigo_tpu_torch.utils import rand64c, rel_err

# the shapes of the CUDA kernel tests (tests/test_torch_cuda.py)
SHAPES = [(64, 256, 0.05), (100, 300, 0.02), (257, 640, 0.01),
          (40, 1000, 0.001), (8, 128, 0.5), (300, 129, 0.05)]
FORMATS = {"jag": (tsp.csr_to_jag, tsp.jag_to_csr, tsp.jag_spmm,
                   jsp.csr_to_jag),
           "bell": (tsp.csr_to_bell, tsp.bell_to_csr, tsp.bell_spmm,
                    jsp.csr_to_bell)}
ROW_FORM = ("row_ptr", "nz_col", "nz_val", "heavy_rows")


def _random(m, n, density, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csr",
                  dtype=np.float32)
    A.data = rng.standard_normal(A.nnz).astype(np.float32)
    return A


def _assert_rows_equal(mat, csr):
    np.testing.assert_array_equal(mat.row_ptr.numpy(), csr.indptr)
    np.testing.assert_array_equal(mat.nz_col.numpy(), csr.indices)
    np.testing.assert_array_equal(mat.nz_val.numpy(), csr.data)


@pytest.mark.parametrize("m,n,density", SHAPES)
@pytest.mark.parametrize("bm", [8, 16, 128])
@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_row_form_equals_to_csr(fmt, bm, m, n, density):
    conv, to_csr, _, _ = FORMATS[fmt]
    mat = conv(_random(m, n, density), bm=bm)
    for name in ROW_FORM:
        assert getattr(mat, name).dtype == (torch.float32 if name == "nz_val"
                                            else torch.int32)
    _assert_rows_equal(mat, to_csr(mat))
    assert mat.nz_val.numel() == mat.nnz


def _edge_matrix():
    """37 x 300 at bm 16 / bn 128: block row 1 (rows 16-31) empty, a ragged
    last row block (rows 32-36) and column block (256-299), a duplicate
    entry, and block row 0 narrower than block row 2, so its ELL padding
    slot (column block 0, zeros) sits beside its genuine column block 0."""
    rows = np.array([0, 0, 0, 3, 33, 33, 34, 34, 34, 36])
    cols = np.array([5, 5, 200, 127, 299, 2, 10, 150, 260, 0])
    vals = np.array([1.5, 2.0, -1.0, 4.0, 3.0, -2.5, 1.0, 0.5, 0.25, 7.0],
                    np.float32)
    return sp.coo_matrix((vals, (rows, cols)), shape=(37, 300))


@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_row_form_edges(fmt):
    conv, to_csr, _, _ = FORMATS[fmt]
    A = _edge_matrix()
    mat = conv(A, bm=16)
    if fmt == "bell":
        assert mat.W == 3 and mat.cols[0].tolist() == [0, 1, 0]
    want = A.tocsr()  # duplicates summed: (0, 5) holds 3.5
    assert want[0, 5] == 3.5 and want.nnz == 9
    _assert_rows_equal(mat, want)
    _assert_rows_equal(mat, to_csr(mat))
    length = np.diff(mat.row_ptr.numpy())
    assert (length[16:32] == 0).all() and length[36] == 1
    assert mat.nz_col.max() == 299 and mat.row_ptr[-1] == 9


@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_heavy_rows_longest_first(fmt, monkeypatch):
    conv = FORMATS[fmt][0]
    A = _edge_matrix()
    mat = conv(A, bm=16)
    assert mat.heavy_nnz == tsp.HEAVY_ROW_NNZ and mat.heavy_rows.numel() == 0
    monkeypatch.setattr(tsp, "HEAVY_ROW_NNZ", 1)
    split = conv(A, bm=16)
    # rows 34 (3 nonzeros), then 0 and 33 (2 each, in row order)
    assert split.heavy_nnz == 1 and split.heavy_rows.tolist() == [34, 0, 33]
    _assert_rows_equal(split, A.tocsr())


@pytest.mark.parametrize("m,n,density", SHAPES[:3])
@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_row_form_from_reference(fmt, m, n, density):
    """A format carried over from the reference's arrays derives the same
    row form as the port's own converter."""
    conv, _, _, ref_conv = FORMATS[fmt]
    A = _random(m, n, density, seed=1)
    got, want = sparse_from_reference(ref_conv(A), device="cpu"), conv(A)
    for name in ROW_FORM:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)


@pytest.mark.parametrize("m,n,density", SHAPES)
@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_row_form_product_matches_plain(fmt, m, n, density):
    conv, _, plain, _ = FORMATS[fmt]
    mat = conv(_random(m, n, density, seed=2), bm=16)
    x = np.random.default_rng(3).standard_normal((n, 16), dtype=np.float32)
    rows = sp.csr_matrix((mat.nz_val.numpy(), mat.nz_col.numpy(),
                          mat.row_ptr.numpy()), shape=mat.shape)
    assert rel_err(rows @ x, plain(mat, torch.from_numpy(x))) < 1e-6


@pytest.mark.parametrize("m,n,density", SHAPES)
def test_jag_and_bell_share_one_row_form(m, n, density):
    """K3 and K4 read the same arrays for the same matrix, whatever the
    tiling, so they give the same bits on the card."""
    A = _random(m, n, density, seed=4)
    j, b = tsp.csr_to_jag(A, bm=8), tsp.csr_to_bell(A, bm=128)
    for name in ROW_FORM:
        assert torch.equal(getattr(j, name), getattr(b, name)), name


@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_row_form_moves_and_round_trips(fmt):
    """The row form is made of registered buffers: ``.to()`` moves it,
    ``deepcopy`` and ``state_dict`` carry it."""
    conv = FORMATS[fmt][0]
    mat = conv(_random(100, 300, 0.02, seed=5))
    keys = set(mat.state_dict())
    assert set(ROW_FORM) <= keys
    assert all(getattr(mat.to("meta"), n).is_meta for n in ROW_FORM)
    mat = conv(_random(100, 300, 0.02, seed=5))
    wide = copy.deepcopy(mat).to(torch.float64)
    assert wide.nz_val.dtype == torch.float64
    assert wide.row_ptr.dtype == wide.nz_col.dtype == torch.int32
    other = conv(_random(100, 300, 0.02, seed=5))
    for name in ROW_FORM:
        getattr(other, name).zero_()
    other.load_state_dict(copy.deepcopy(mat.state_dict()))
    for name in ROW_FORM:
        assert torch.equal(getattr(other, name), getattr(mat, name)), name


@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_complex_format_has_no_row_form(fmt):
    """A complex-valued matrix derives nothing and keeps the plain path (on
    the card too: the kernel wrappers refuse it, ``ops.spmm`` counts it)."""
    from indigo_tpu_torch.ops.ell_spmm import _check_inputs

    conv = FORMATS[fmt][0]
    A = (_random(60, 200, 0.05, seed=6) * (1 - 2j)).astype(np.complex64)
    mat = conv(A)
    assert all(getattr(mat, n) is None for n in ROW_FORM)
    assert not set(ROW_FORM) & set(mat.state_dict())
    x = rand64c(200, 3, rng=7)
    assert rel_err(spmm(mat, torch.from_numpy(x)), A @ x) < 1e-5
    with pytest.raises(TypeError):
        _check_inputs("spmm", mat, torch.zeros(200, 3))


def test_row_form_refuses_more_than_int32(monkeypatch):
    monkeypatch.setattr(tsp, "MAX_ROW_NNZ", 10)
    A = _random(40, 100, 0.1, seed=8)
    assert A.nnz > 10
    with pytest.raises(ValueError, match="int32"):
        tsp.csr_to_jag(A)
