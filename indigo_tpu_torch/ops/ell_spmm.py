"""Block-sparse SpMM: wrappers of the CUDA kernels K3 (jag) and K4 (ELL).

Counterpart of ``indigo_tpu/ops/ell_spmm.py`` (``jag_spmm_pallas``,
``ell_spmm_pallas``). ``jag_spmm_cuda`` and ``ell_spmm_cuda`` launch the
hand-written row-gather kernel of ``csrc/block_spmm.cu`` on the current
CUDA stream. It reads the matrix's row form (``row_ptr``, ``nz_col``,
``nz_val``, ``heavy_rows``: the stored nonzeros, derived by ``sparse.py``
from the tiles), never the dense tiles, so any bm and bn run. On CPU
tensors the wrappers run the plain torch versions ``sparse.jag_spmm`` /
``sparse.bell_spmm``, which are also what the kernels are compared with on
the card. The kernels are built on first use (``ops/_build.py``), never at
import. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from ..sparse import BlockedELL, BlockedJag, bell_spmm, jag_spmm

__all__ = ["jag_spmm_cuda", "ell_spmm_cuda"]


def _check_inputs(name, A, x):
    """Raise on anything the kernel does not take; returns (M, K)."""
    M, N = A.shape
    if A.nz_val is None:
        raise TypeError(f"{name}: a {A.data.dtype} matrix has no row form "
                        "(a complex matrix takes the plain version)")
    idx = (A.row_ptr, A.nz_col, A.heavy_rows)
    tensors = idx + (A.nz_val, x)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name}: the matrix and x must share one CUDA "
                         "device")
    if A.nz_val.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: nz_val and x must be float32, got "
                        f"{A.nz_val.dtype} and {x.dtype}")
    if any(t.dtype != torch.int32 for t in idx):
        raise TypeError(f"{name}: row_ptr, nz_col and heavy_rows must be "
                        "int32")
    if x.dim() != 2 or x.shape[0] != N or x.shape[1] < 1:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the "
                         f"matrix is {M}x{N} (x must be (N, K), K >= 1)")
    if A.row_ptr.shape != (M + 1,):
        raise ValueError(f"{name}: row_ptr has shape "
                         f"{tuple(A.row_ptr.shape)}, expected ({M + 1},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the row form and x must be contiguous")
    return M, int(x.shape[1])


def _launch(name, entry, A, x):
    """Check, allocate y, launch ``entry`` on the current stream."""
    M, K = _check_inputs(name, A, x)
    from ._build import load_library
    lib = load_library()
    y = torch.empty((M, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = getattr(lib, entry)(
            A.row_ptr.data_ptr(), A.nz_col.data_ptr(), A.nz_val.data_ptr(),
            A.heavy_rows.data_ptr(), A.heavy_rows.numel(),
            A.heavy_nnz or -1, x.data_ptr(), y.data_ptr(), M, K,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.indigo_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
    return y


def jag_spmm_cuda(jag: BlockedJag, x):
    """y = A @ x for a float32 BlockedJag A and float32 x (N, K), kernel K3.

    Eight lanes (or more for wide K) per output row gather the x rows of
    its stored nonzeros and write the row once; rows longer than
    ``jag.heavy_nnz`` are split across one CUDA block with a fixed-order
    sum. No atomics, empty rows exactly zero, bitwise deterministic. CPU
    tensors run ``sparse.jag_spmm``.
    """
    if x.device.type == "cpu":
        return jag_spmm(jag, x)
    y = _launch("jag_spmm_cuda", "indigo_jag_spmm", jag, x)
    jag_spmm_cuda.launches += 1
    return y


jag_spmm_cuda.launches = 0


def ell_spmm_cuda(ell: BlockedELL, x):
    """y = A @ x for a float32 BlockedELL A and float32 x (N, K), kernel K4:
    the same kernel as K3 on the ELL matrix's row form, where the padding
    slots have dropped out. CPU tensors run ``sparse.bell_spmm``.
    """
    if x.device.type == "cpu":
        return bell_spmm(ell, x)
    y = _launch("ell_spmm_cuda", "indigo_ell_spmm", ell, x)
    ell_spmm_cuda.launches += 1
    return y


ell_spmm_cuda.launches = 0
