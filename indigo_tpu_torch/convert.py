"""Carry a reference pipeline's arrays across to the port.

``state_from_reference_arrays`` gathers the numpy arrays that define an
``indigo_tpu`` ``SenseRecon`` — the raw Toeplitz spectrum, coil maps,
sorted DCF weights, sample permutation, deapodization, the tile plan's
``tid``/``wfac`` and geometry, ``lamda`` and ``iters`` — into one checked
dict; ``SenseRecon.from_arrays(state, device)`` builds the port's pipeline
from it with no geometry recomputed. Both packages then solve on identical
state: the port's counterpart of loading checkpoint weights.

``sparse_from_reference`` carries a reference block-sparse matrix
(``BlockedJag``, ``BlockedELL``, ``ElementELL``) across, and
``spmatrix_from_reference`` a reference ``SpMatrix`` leaf, so that both
packages apply the same tiles; ``toeplitz_from_reference`` does the same for
a ``ToeplitzNormal`` leaf and its spectrum, and ``operator_from_reference``
for a whole operator tree (every operator class of the port, ``DWT``
included), walked by class name. This module reads the reference objects'
arrays through numpy only and imports nothing of the reference.

Each function that builds an operator or a format takes ``device`` with
the port's rule (``utils.as_tensor``): by default the card, and an error
where there is none; ``device="cpu"`` builds on the host.
"""
from __future__ import annotations

import numpy as np

from .utils import default_device

__all__ = ["state_from_reference_arrays", "sparse_from_reference",
           "spmatrix_from_reference", "toeplitz_from_reference",
           "operator_from_reference", "sharded_state_from_reference"]


def state_from_reference_arrays(*, Tf, maps, w_sorted, perm, deapod, tid,
                                wfac, grid_shape, tile, ext, nt, pad_lo,
                                width, lamda, iters):
    """Check and normalise the arrays of a reference SenseRecon.

    Tf: raw (natural frequency order) doubled-grid spectrum, 2x the image
    shape; maps (nc, *img); w_sorted (nc*M,); perm (M,); deapod (*img);
    tid (M, S); wfac: one (M, n_d, t_d) array per axis.
    """
    maps = np.asarray(maps, np.complex64)
    nc, img = maps.shape[0], tuple(maps.shape[1:])
    Tf = np.asarray(Tf, np.float32)
    if Tf.shape != tuple(2 * s for s in img):
        raise ValueError(f"Tf shape {Tf.shape} is not 2x image {img}")
    perm = np.asarray(perm, np.int64)
    M = len(perm)
    tid = np.asarray(tid, np.int32)
    wfac = [np.asarray(w, np.float32) for w in wfac]
    if tid.shape[0] != M or any(w.shape[0] != M for w in wfac):
        raise ValueError("tile plan and perm disagree on the sample count")
    if len(wfac) != len(img) or len(grid_shape) != len(img):
        raise ValueError("tile plan rank differs from the image rank")
    w_sorted = np.asarray(w_sorted, np.float32).ravel()
    if w_sorted.shape[0] != nc * M:
        raise ValueError(f"w_sorted has {w_sorted.shape[0]} entries, "
                         f"expected {nc}x{M}")
    deapod = np.asarray(deapod, np.float32)
    if deapod.shape != img:
        raise ValueError(f"deapod shape {deapod.shape} != image {img}")
    return {
        "Tf": Tf, "maps": maps, "w_sorted": w_sorted, "perm": perm,
        "deapod": deapod, "tid": tid, "wfac": wfac,
        "grid_shape": tuple(int(g) for g in grid_shape),
        "tile": tuple(int(t) for t in tile),
        "ext": tuple(int(e) for e in ext), "nt": tuple(int(n) for n in nt),
        "pad_lo": tuple(int(p) for p in pad_lo), "width": int(width),
        "lamda": float(lamda), "iters": int(iters),
    }


def _host(a):
    """numpy array of a reference payload; a split-complex pair (``re`` and
    ``im`` planes) becomes complex64."""
    if a is None:
        return None
    if hasattr(a, "re") and hasattr(a, "im"):
        return (np.asarray(a.re) + 1j * np.asarray(a.im)).astype(
            np.complex64)
    return np.asarray(a)


def sparse_from_reference(m, device=None):
    """The port's BlockedJag / BlockedELL / ElementELL with the arrays of
    the reference object ``m`` (same class name), on ``device``."""
    return _sparse_from_reference(m).to(default_device(device))


def _sparse_from_reference(m):
    import torch

    from . import sparse

    def t(a):
        a = _host(a)
        return None if a is None else torch.from_numpy(np.array(a))

    kind = type(m).__name__
    if kind == "BlockedJag":
        return sparse.BlockedJag(t(m.data), t(m.bcols), t(m.brows), m.shape,
                                 nnz=m.nnz)
    if kind == "BlockedELL":
        return sparse.BlockedELL(t(m.data), t(m.cols), m.shape, nnz=m.nnz)
    if kind == "ElementELL":
        return sparse.ElementELL(t(m.data), t(m.cols), m.shape, nnz=m.nnz,
                                 adj_rows=t(m.adj_rows),
                                 adj_vals=t(m.adj_vals),
                                 adj_segs=t(m.adj_segs))
    raise TypeError(f"not a reference sparse format: {kind}")


def spmatrix_from_reference(op, device=None):
    """The port's SpMatrix built from a reference SpMatrix's ``ell`` and
    ``ellH`` tiles (no conversion from CSR on this side), on ``device``."""
    from .operators import SpMatrix

    ellH = None if op.ellH is None else _sparse_from_reference(op.ellH)
    return SpMatrix(None, name=op._name, _ell=_sparse_from_reference(op.ell),
                    _ellH=ellH, device=default_device(device))


def toeplitz_from_reference(op, device=None):
    """The port's ToeplitzNormal with the spectrum of a reference one
    (its ``_T``, ``_vol``, ``_method``, ``_name``), under the same method,
    on ``device``.

    The reference stores "pallas" as ``pallas_spectrum``: block layout
    transposed to (Y, Z, X). That transpose is undone, then block order
    ("pallas", "dft") is mapped back to the raw spectrum, which the port's
    constructor takes; "fft" is raw already. Every step is a permutation,
    so the port ends up with the same values.
    """
    from .ops.dft_fft import block_perm
    from .toeplitz import ToeplitzNormal

    T = np.asarray(op._T, np.float32)
    if op._method == "pallas":
        T = np.transpose(T, (1, 0, 2))
    if op._method in ("pallas", "dft"):
        T = T[np.ix_(*(np.argsort(block_perm(s)) for s in T.shape))]
    return ToeplitzNormal(T, op._vol, name=op._name, method=op._method,
                          device=default_device(device))


def _plan_from_reference(p):
    from .ops.tile_interp import TileInterpPlan

    return TileInterpPlan(
        np.asarray(p.tid), [np.asarray(w) for w in p.wfac], p.grid_shape,
        p.tile, p.ext, p.nt, p.pad_lo, p.width,
        sample_perm=getattr(p, "sample_perm", None))


def operator_from_reference(op, device=None):
    """The port's operator tree with the structure and arrays of the
    reference tree ``op``, on ``device`` (every leaf, those without arrays
    too).

    The tree is walked by class name, so nothing of the reference is
    imported: every combinator is rebuilt around its converted children and
    every leaf from the reference leaf's own arrays (split-complex payloads
    become complex64), so both packages apply the same numbers.
    """
    from . import operators as O
    from .wavelet import DWT

    device = default_device(device)
    kind = type(op).__name__
    name = getattr(op, "_name", None)
    conv = lambda child: operator_from_reference(child, device)  # noqa: E731
    dt = lambda: np.dtype(str(op.dtype))  # noqa: E731
    on = {"name": name, "device": device}
    if kind == "Product":
        return O.Product(conv(op.left), conv(op.right), name=name)
    if kind == "Adjoint":
        return O.Adjoint(conv(op.child), name=name)
    if kind == "KronI":
        return O.KronI(op.c, conv(op.child), name=name)
    if kind in ("BlockDiag", "VStack", "HStack"):
        return getattr(O, kind)([conv(b) for b in op.blocks], name=name)
    if kind == "Scale":
        return O.Scale(_host(op.alpha).item(), conv(op.child), name=name)
    if kind == "SpMatrix":
        return spmatrix_from_reference(op, device)
    if kind == "ToeplitzNormal":
        return toeplitz_from_reference(op, device)
    if kind == "KBInterp":
        return O.KBInterp(_plan_from_reference(op.plan), **on)
    if kind == "GridDFT":
        return O.GridDFT(_plan_from_reference(op.plan), op.img_shape, **on)
    if kind == "CenteredDFT":
        return O.CenteredDFT(op.img_shape, op.grid_shape, **on)
    if kind == "DenseMatrix":
        return O.DenseMatrix(np.array(_host(op._A)), **on)
    if kind == "Diag":
        return O.Diag(np.array(_host(op.payload)), **on)
    if kind == "UnscaledFFT":
        return O.UnscaledFFT(op.vol_shape, dtype=dt(), **on)
    if kind == "Eye":
        return O.Eye(op.shape[0], dtype=dt(), **on)
    if kind == "One":
        return O.One(op.shape, dtype=dt(), **on)
    if kind == "CropPad":
        return O.CropPad(op.in_shape, op.out_shape, dtype=dt(), **on)
    if kind == "Perm":
        return O.Perm(np.asarray(op.perm), dtype=dt(), **on)
    if kind == "Mask":
        return O.Mask(np.asarray(op.keep), op.shape[1], dtype=dt(), **on)
    if kind == "DWT":
        return DWT(op.vol_shape, wavelet=op._wavelet, levels=op._levels,
                   dtype=dt(), **on)
    raise TypeError(f"not a reference operator the port knows: {kind}")


def sharded_state_from_reference(rec):
    """The host state of a reference ``SenseReconSharded`` as numpy arrays
    and plain values: ``perm``, ``Bmats``, ``dam``, ``Tf``, ``lamda``,
    ``grid_shape``, ``nt``, and ``chunks``/``w_chunks`` (3D) or ``w_sorted``
    (2D). The port's object holds the same under the same names (its
    tensors are this rank's blocks where the volume is sharded)."""
    state = {
        "perm": np.asarray(rec.perm, np.int64),
        "Bmats": [np.asarray(_host(B), np.complex64) for B in rec._Bmats],
        "dam": np.asarray(_host(rec._dam), np.complex64),
        "Tf": np.asarray(rec._Tf, np.float32),
        "lamda": float(rec.lamda),
        "grid_shape": tuple(int(g) for g in rec.grid_shape),
        "nt": tuple(int(n) for n in rec.nt),
    }
    if rec.ndim == 3:
        state["chunks"] = np.asarray(rec._chunks, np.int64)
        state["w_chunks"] = np.asarray(rec._w_chunks, np.float32)
    else:
        state["w_sorted"] = np.asarray(rec._w_sorted, np.float32)
    return state
