"""Block-sparse formats for the gridding SpMM, their converters and the
plain torch SpMMs.

Counterpart of ``indigo_tpu/sparse.py``. A scipy CSR matrix is converted
once on the host into fixed-size (bm, bn) dense f32 blocks; both the forward
matrix and its conjugate transpose are tiled (see ``operators.SpMatrix``), so
both directions of an apply are gathers.

  * :class:`BlockedJag` — ragged blocked-CSR, sorted by block row; on CUDA
    it runs kernel K3 (``ops.ell_spmm.jag_spmm_cuda``).
  * :class:`BlockedELL` — fixed width W per block row; on CUDA it runs
    kernel K4 (``ops.ell_spmm.ell_spmm_cuda``).
  * :class:`ElementELL` — exactly-nnz element storage for matrices whose
    blocks would be almost empty; plain torch only, as in the reference.

The converters produce arrays equal to the reference's (same ``auto_bm``
rule and ``smem_budget`` default, so a layout is the same on both
packages). Complex data is native complex64 (the reference splits it into
``CPair`` planes). Each format is an ``nn.Module`` holding its arrays as
buffers, so ``.to(device)`` moves it. ``jag_spmm``, ``bell_spmm`` and
``element_spmm`` are the plain torch versions: the CPU path, and what the
CUDA kernels are held against on the card.

The dense tiles exist for the TPU's matrix unit. A real-valued
:class:`BlockedJag` or :class:`BlockedELL` also derives, on the host and
from its own ``data``, the *row form* that K3 and K4 read on the card: the
stored nonzeros in CSR order (``row_ptr``, ``nz_col``, ``nz_val``; ELL
padding, zeros inside a tile and entries past the matrix edge drop out)
and ``heavy_rows``, the rows longer than ``heavy_nnz`` nonzeros, longest
first, which the kernel splits across one CUDA block.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .ops.dft_fft import full_f32_matmul
from .utils import NARROW

__all__ = [
    "BlockedELL", "csr_to_bell", "bell_spmm", "bell_to_csr",
    "BlockedJag", "csr_to_jag", "jag_spmm", "jag_to_csr",
    "ElementELL", "csr_to_element", "element_spmm", "element_to_csr",
    "estimate_jag_bytes",
]


def _t(a):
    """A host array as a tensor; a 64-bit float or complex one (the
    converters' ``dtype=np.float64``) narrowed as ``utils.as_tensor``
    narrows, after it was built and summed in 64-bit as the reference's."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.astype(NARROW.get(a.dtype, a.dtype),
                                     copy=False))


def _np(t):
    return t.detach().cpu().numpy()


# a row with more stored nonzeros than this is split across one CUDA block by
# K3/K4 (G^H of the 2D radial recipe has rows of up to ~2,000 near the
# k-space centre, where its mean is 21; chip_smoke.py times other values)
HEAVY_ROW_NNZ = 128
# the kernels index the row form with int32
MAX_ROW_NNZ = 2**31 - 1
_ROW_FORM = ("row_ptr", "nz_col", "nz_val", "heavy_rows")


class _Format(nn.Module):
    """Shared surface: logical ``shape`` (M, N), ``nnz``, ``data``."""

    def __init__(self, shape, nnz):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)

    def _derive_rows(self):
        """Register the row form from ``_stored_entries()``: CSR with
        duplicates summed, columns sorted, entries outside (M, N) dropped;
        all None for complex data, which keeps the plain path. ``heavy_nnz``
        records the threshold ``heavy_rows`` was derived with."""
        self.heavy_nnz = heavy_nnz = HEAVY_ROW_NNZ
        if self.data.is_complex():
            for name in _ROW_FORM:
                self.register_buffer(name, None)
            return
        rows, cols, vals = self._stored_entries(_np(self.data))
        M, N = self.shape
        keep = (rows < M) & (cols < N)
        csr = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                            shape=(M, N))
        if csr.nnz > MAX_ROW_NNZ:
            raise ValueError(f"{csr.nnz} stored nonzeros: the row form "
                             f"indexes at most {MAX_ROW_NNZ} with int32")
        length = np.diff(csr.indptr)
        heavy = np.flatnonzero(length > heavy_nnz)
        heavy = heavy[np.argsort(-length[heavy], kind="stable")]
        for name, a in (("row_ptr", csr.indptr.astype(np.int32)),
                        ("nz_col", csr.indices.astype(np.int32)),
                        ("nz_val", csr.data),
                        ("heavy_rows", heavy.astype(np.int32))):
            self.register_buffer(name, _t(a).to(self.data.device))

    @property
    def dtype(self):
        return self.data.dtype

    def memusage(self):
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def fill_fraction(self):
        """nnz / stored entries."""
        stored = self.data.numel()
        return self.nnz / stored if stored else 0.0


class BlockedELL(_Format):
    """Fixed-width blocked-ELL matrix.

    data: (R, W, bm, bn) dense blocks, float32 or complex64.
    cols: (R, W) int32 column-block indices; padding slots point at block 0
    with all-zero data. R = ceil(M/bm), C = ceil(N/bn).
    row_ptr, nz_col, nz_val, heavy_rows: the row form (module docstring).
    """

    def __init__(self, data, cols, shape, nnz=0):
        super().__init__(shape, nnz)
        self.register_buffer("data", torch.as_tensor(data))
        self.register_buffer("cols", torch.as_tensor(cols))
        self._derive_rows()

    def _stored_entries(self, d):
        """(row, column, value) of every nonzero of the tiles ``d``."""
        r, w, i, j = np.nonzero(d)
        return (r.astype(np.int64) * self.bm + i,
                _np(self.cols)[r, w].astype(np.int64) * self.bn + j,
                d[r, w, i, j])

    bm = property(lambda self: self.data.shape[2])
    bn = property(lambda self: self.data.shape[3])
    R = property(lambda self: self.data.shape[0])
    W = property(lambda self: self.data.shape[1])

    @property
    def C(self):
        return -(-self.shape[1] // self.bn)

    def extra_repr(self):
        return (f"shape={self.shape}, blocks={tuple(self.data.shape[:2])}, "
                f"tile=({self.bm},{self.bn}), dtype={self.dtype}, "
                f"nnz={self.nnz}, fill={self.fill_fraction():.4f}")


def csr_to_bell(A, bm=8, bn=128, dtype=None):
    """scipy sparse -> :class:`BlockedELL` (host-side numpy, the reference's
    vectorised build: one sort for the slot assignment, duplicates summed
    with ``np.add.at``)."""
    A = sp.coo_matrix(A)
    M, N = A.shape
    if dtype is None:
        dtype = np.complex64 if np.iscomplexobj(A.data) else np.float32
    R = max(-(-M // bm) if M else 1, 1)
    C = max(-(-N // bn) if N else 1, 1)

    if A.nnz == 0:
        return BlockedELL(_t(np.zeros((R, 1, bm, bn), dtype=dtype)),
                          _t(np.zeros((R, 1), dtype=np.int32)), (M, N))

    rows = A.row.astype(np.int64)
    colsx = A.col.astype(np.int64)
    brow = rows // bm
    key = brow * C + colsx // bn
    ukey, inv = np.unique(key, return_inverse=True)
    ubrow = ukey // C
    ubcol = ukey % C
    # slot of each unique (row-block, col-block) pair within its row-block
    first_in_brow = np.zeros(len(ukey), dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, ubrow[1:] != ubrow[:-1]])
    first_in_brow[starts] = np.arange(len(ukey))[starts]
    np.maximum.accumulate(first_in_brow, out=first_in_brow)
    uslot = np.arange(len(ukey)) - first_in_brow
    W = int(uslot.max()) + 1

    data = np.zeros((R, W, bm, bn), dtype=dtype)
    cols = np.zeros((R, W), dtype=np.int32)
    cols[ubrow, uslot] = ubcol.astype(np.int32)
    np.add.at(data, (brow, uslot[inv], rows % bm, colsx % bn),
              A.data.astype(dtype))
    return BlockedELL(_t(data), _t(cols), (M, N), nnz=int(A.nnz))


def bell_to_csr(ell):
    """Inverse conversion (testing): BlockedELL -> scipy CSR."""
    data, cols = _np(ell.data), _np(ell.cols)
    R, W, bm, bn = data.shape
    M, N = ell.shape
    r_blk = np.repeat(np.arange(R), W * bm * bn)
    slot = np.tile(np.repeat(np.arange(W), bm * bn), R)
    rows = r_blk * bm + np.tile(np.repeat(np.arange(bm), bn), R * W)
    ccols = cols[r_blk, slot] * bn + np.tile(np.arange(bn), R * W * bm)
    vals = data.reshape(-1)
    keep = (vals != 0) & (rows < M) & (ccols < N)
    return sp.coo_matrix((vals[keep], (rows[keep], ccols[keep])),
                         shape=(M, N)).tocsr()


class BlockedJag(_Format):
    """Ragged blocked-CSR: a variable number of blocks per block row.

    data:  (NB, bm, bn) dense blocks, float32 or complex64
    bcols: (NB,) int32 column-block index of each stored block
    brows: (NB,) int32 row-block index, non-decreasing; every block row in
           [0, R) appears at least once (an empty row carries one zero
           block), as the reference lays it out
    bptr:  (R+1,) int32 offsets of each block row's run in ``brows``,
           computed on the host (the TPU kernel scalar-prefetched ``brows``)
    row_ptr, nz_col, nz_val, heavy_rows: the row form (module docstring).
    """

    def __init__(self, data, bcols, brows, shape, nnz=0):
        super().__init__(shape, nnz)
        self.register_buffer("data", torch.as_tensor(data))
        self.register_buffer("bcols", torch.as_tensor(bcols))
        self.register_buffer("brows", torch.as_tensor(brows))
        self.register_buffer("bptr", _t(np.searchsorted(
            _np(self.brows), np.arange(self.R + 1)).astype(np.int32)).to(
                self.brows.device))
        self._derive_rows()

    def _stored_entries(self, d):
        """(row, column, value) of every nonzero of the tiles ``d``."""
        b, i, j = np.nonzero(d)
        return (_np(self.brows)[b].astype(np.int64) * self.bm + i,
                _np(self.bcols)[b].astype(np.int64) * self.bn + j,
                d[b, i, j])

    bm = property(lambda self: self.data.shape[1])
    bn = property(lambda self: self.data.shape[2])
    NB = property(lambda self: self.data.shape[0])

    @property
    def R(self):
        return max(1, -(-self.shape[0] // self.bm))

    @property
    def C(self):
        return max(1, -(-self.shape[1] // self.bn))

    def extra_repr(self):
        return (f"shape={self.shape}, NB={self.NB}, tile=({self.bm},"
                f"{self.bn}), dtype={self.dtype}, nnz={self.nnz}, "
                f"fill={self.fill_fraction():.4f}")


def csr_to_jag(A, bm=8, bn=128, dtype=None, auto_bm=True,
               smem_budget=400 * 1024):
    """scipy sparse -> :class:`BlockedJag` (host-side, vectorised numpy).

    With ``auto_bm``, bm doubles (up to 128) while the block index arrays
    exceed ``smem_budget`` bytes — the reference's rule (it sized the TPU's
    scalar-prefetch memory), kept so that layouts are equal on both
    packages.
    """
    A = sp.coo_matrix(A)
    M, N = A.shape
    if dtype is None:
        dtype = np.complex64 if np.iscomplexobj(A.data) else np.float32

    while True:
        R = max(1, -(-M // bm) if M else 1)
        C = max(1, -(-N // bn) if N else 1)
        if A.nnz == 0:
            return BlockedJag(_t(np.zeros((R, bm, bn), dtype=dtype)),
                              _t(np.zeros((R,), np.int32)),
                              _t(np.arange(R, dtype=np.int32)), (M, N))
        rows = A.row.astype(np.int64)
        colsx = A.col.astype(np.int64)
        key = (rows // bm) * C + colsx // bn
        ukey, inv = np.unique(key, return_inverse=True)
        ubrow = (ukey // C).astype(np.int64)
        # one zero block for every empty block row
        missing = np.setdiff1d(np.arange(R, dtype=np.int64), ubrow)
        NB = len(ukey) + len(missing)
        if auto_bm and 2 * 4 * NB > smem_budget and bm < 128:
            bm *= 2
            continue
        break

    all_brow = np.concatenate([ubrow, missing])
    all_bcol = np.concatenate([(ukey % C).astype(np.int64),
                               np.zeros(len(missing), np.int64)])
    order = np.argsort(all_brow, kind="stable")
    all_brow = all_brow[order]
    all_bcol = all_bcol[order]
    pos = np.empty(NB, dtype=np.int64)
    pos[order] = np.arange(NB)

    data = np.zeros((NB, bm, bn), dtype=dtype)
    np.add.at(data, (pos[inv], rows % bm, colsx % bn), A.data.astype(dtype))
    return BlockedJag(_t(data), _t(all_bcol.astype(np.int32)),
                      _t(all_brow.astype(np.int32)), (M, N), nnz=int(A.nnz))


def jag_to_csr(jag):
    """Inverse conversion (testing): BlockedJag -> scipy CSR."""
    data, bcols, brows = _np(jag.data), _np(jag.bcols), _np(jag.brows)
    NB, bm, bn = data.shape
    M, N = jag.shape
    b = np.repeat(np.arange(NB), bm * bn)
    rows = brows[b] * bm + np.tile(np.repeat(np.arange(bm), bn), NB)
    ccols = bcols[b] * bn + np.tile(np.arange(bn), NB * bm)
    vals = data.reshape(-1)
    keep = (vals != 0) & (rows < M) & (ccols < N)
    return sp.coo_matrix((vals[keep], (rows[keep], ccols[keep])),
                         shape=(M, N)).tocsr()


class ElementELL(_Format):
    """Element-level ELL: exactly-nnz storage for very sparse matrices.

    data: (M, L) weights (rows padded with zeros), cols: (M, L) int32.
    The forward apply is a gather + reduce. The adjoint gathers the
    column-sorted copy (``adj_rows``/``adj_vals``/``adj_segs``) and sums
    its segments, or scatter-adds from ``data``/``cols`` without it.
    """

    def __init__(self, data, cols, shape, nnz=0, adj_rows=None,
                 adj_vals=None, adj_segs=None):
        super().__init__(shape, nnz)
        self.register_buffer("data", torch.as_tensor(data))
        self.register_buffer("cols", torch.as_tensor(cols))
        for name, a in (("adj_rows", adj_rows), ("adj_vals", adj_vals),
                        ("adj_segs", adj_segs)):
            self.register_buffer(
                name, None if a is None else torch.as_tensor(a))

    @property
    def L(self):
        return self.data.shape[1]

    def extra_repr(self):
        return (f"shape={self.shape}, L={self.L}, dtype={self.dtype}, "
                f"nnz={self.nnz}")


def csr_to_element(A, dtype=None, adjoint_segments=True):
    """scipy sparse -> ElementELL (host-side). ``adjoint_segments`` also
    stores the nonzeros sorted by column for a gather-shaped adjoint."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    M, N = A.shape
    if dtype is None:
        dtype = np.complex64 if np.iscomplexobj(A.data) else np.float32
    nnz_row = np.diff(A.indptr)
    L = max(1, int(nnz_row.max()) if M else 1)
    data = np.zeros((max(M, 1), L), dtype=dtype)
    cols = np.zeros((max(M, 1), L), dtype=np.int32)
    r = np.repeat(np.arange(M), nnz_row)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)
    data[r, slot] = A.data.astype(dtype)
    cols[r, slot] = A.indices
    adj = {}
    if adjoint_segments and A.nnz:
        Ac = A.tocsc()
        adj = dict(
            adj_vals=_t(Ac.data.astype(dtype)),
            adj_rows=_t(Ac.indices.astype(np.int32)),
            adj_segs=_t(np.repeat(np.arange(N), np.diff(Ac.indptr))
                        .astype(np.int32)))
    return ElementELL(_t(data), _t(cols), (M, N), nnz=int(A.nnz), **adj)


def element_to_csr(e):
    data, cols = _np(e.data), _np(e.cols)
    rows = np.repeat(np.arange(data.shape[0]), data.shape[1])
    keep = data.ravel() != 0
    return sp.coo_matrix(
        (data.ravel()[keep], (rows[keep], cols.ravel()[keep])),
        shape=e.shape).tocsr()


def _out_dtype(data, x):
    return torch.promote_types(data.dtype, x.dtype)


def element_spmm(e, x, adjoint=False, precision="highest"):
    """y = A @ x (or A^H @ x) for ElementELL A: forward gather + reduce;
    adjoint sorted-segment sum (or scatter-add) of conj weights.
    ``precision`` is the reference's TPU matmul knob, accepted and ignored:
    every product here is full f32."""
    M, N = e.shape
    K = x.shape[1]
    dt = _out_dtype(e.data, x)
    x = x.to(dt)
    if adjoint:
        if e.adj_segs is not None:
            vals = e.adj_vals.to(dt).conj()
            contrib = vals[:, None] * x[e.adj_rows.long()]
            return torch.zeros((N, K), dtype=dt, device=x.device).index_add_(
                0, e.adj_segs.long(), contrib)
        contrib = e.data.to(dt).conj()[..., None] * x[:, None, :]
        return torch.zeros((N, K), dtype=dt, device=x.device).index_add_(
            0, e.cols.reshape(-1).long(), contrib.reshape(-1, K))
    g = x[e.cols.long()]  # (M, L, K)
    return torch.einsum("ml,mlk->mk", e.data.to(dt), g)[:M]


def estimate_jag_bytes(A, bm=8, bn=128):
    """Cheap host estimate of BlockedJag tile bytes (no materialisation),
    counting the zero block every empty block row carries."""
    A = sp.coo_matrix(A)
    esz = 8 if np.iscomplexobj(A.data) else 4
    R = max(1, -(-A.shape[0] // bm))
    if A.nnz == 0:
        return R * bm * bn * esz
    C = max(1, -(-A.shape[1] // bn))
    key = (A.row.astype(np.int64) // bm) * C + A.col.astype(np.int64) // bn
    ukey = np.unique(key)
    n_brows = len(np.unique(ukey // C))
    return (len(ukey) + (R - n_brows)) * bm * bn * esz


def _x_blocks(x, C, bn):
    """x (N, K) -> (C, bn, K), zero-padding the ragged last column block."""
    pad = C * bn - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return x.reshape(C, bn, -1)


def jag_spmm(jag, x, precision="highest"):
    """y = A @ x for BlockedJag A — plain torch: gather the x slab of every
    block, one batched product, then a sum over ``brows``. In full f32 (TF32
    off) on CUDA, matching the reference's ``Precision.HIGHEST``
    (``precision`` is accepted for call compatibility and ignored)."""
    if x.is_cuda:
        full_f32_matmul()
    M = jag.shape[0]
    K = x.shape[1]
    dt = _out_dtype(jag.data, x)
    xb = _x_blocks(x.to(dt), jag.C, jag.bn)
    prod = torch.bmm(jag.data.to(dt), xb[jag.bcols.long()])  # (NB, bm, K)
    y = torch.zeros((jag.R, jag.bm, K), dtype=dt, device=x.device)
    y.index_add_(0, jag.brows.long(), prod)
    return y.reshape(-1, K)[:M]


def bell_spmm(ell, x, precision="highest"):
    """y = A @ x for BlockedELL A — plain torch, one gather + batched
    product per ELL slot. Full f32 on CUDA, as :func:`jag_spmm`
    (``precision`` likewise ignored)."""
    if x.is_cuda:
        full_f32_matmul()
    M = ell.shape[0]
    K = x.shape[1]
    dt = _out_dtype(ell.data, x)
    xb = _x_blocks(x.to(dt), ell.C, ell.bn)
    data = ell.data.to(dt)
    cols = ell.cols.long()
    y = torch.zeros((ell.R, ell.bm, K), dtype=dt, device=x.device)
    for w in range(ell.W):
        y += torch.bmm(data[:, w], xb[cols[:, w]])
    return y.reshape(-1, K)[:M]
