"""Block-sparse SpMM: wrappers of the CUDA kernels K3 (jag) and K4 (ELL).

Counterpart of ``indigo_tpu/ops/ell_spmm.py`` (``jag_spmm_pallas``,
``ell_spmm_pallas``). ``jag_spmm_cuda`` and ``ell_spmm_cuda`` launch the
hand-written kernels of ``csrc/block_spmm.cu`` on the current CUDA stream;
on CPU tensors they run the plain torch versions ``sparse.jag_spmm`` /
``sparse.bell_spmm``, which are also what the kernels are compared with on
the card. The kernels are built on first use (``ops/_build.py``), never at
import. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from ..sparse import BlockedELL, BlockedJag, bell_spmm, jag_spmm

__all__ = ["jag_spmm_cuda", "ell_spmm_cuda", "SUPPORTED_BM", "BN"]

SUPPORTED_BM = (8, 16, 32, 64, 128)
BN = 128


def _check_inputs(name, A, idx, x):
    """Raise on anything the kernels do not take; returns (M, N, K)."""
    M, N = A.shape
    tensors = (A.data, x) + idx
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name}: the matrix and x must share one CUDA "
                         "device")
    if A.data.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: data and x must be float32, got "
                        f"{A.data.dtype} and {x.dtype}")
    if any(t.dtype != torch.int32 for t in idx):
        raise TypeError(f"{name}: block indices must be int32")
    if x.dim() != 2 or x.shape[0] != N or x.shape[1] < 1:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the "
                         f"matrix is {M}x{N} (x must be (N, K), K >= 1)")
    if A.bm not in SUPPORTED_BM or A.bn != BN:
        raise ValueError(f"{name}: tile ({A.bm}, {A.bn}) not supported: "
                         f"bm in {SUPPORTED_BM}, bn = {BN}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: data, indices and x must be contiguous")
    if A.data.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    return M, N, int(x.shape[1])


def _raise_on(lib, code, name):
    if code != 0:
        msg = lib.indigo_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def jag_spmm_cuda(jag: BlockedJag, x):
    """y = A @ x for a float32 BlockedJag A and float32 x (N, K), kernel K3.

    One CUDA block per block row walks its own run of stored blocks
    (``bptr``) and writes its (bm, K) output tile once: no atomics, empty
    rows exactly zero, deterministic. CPU tensors run ``sparse.jag_spmm``.
    """
    if x.device.type == "cpu":
        return jag_spmm(jag, x)
    M, N, K = _check_inputs("jag_spmm_cuda", jag, (jag.bcols, jag.bptr), x)
    from ._build import load_library
    lib = load_library()
    y = torch.empty((M, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.indigo_jag_spmm(
            jag.data.data_ptr(), jag.bcols.data_ptr(), jag.bptr.data_ptr(),
            jag.R, jag.bm, x.data_ptr(), y.data_ptr(), M, N, K,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, code, "jag_spmm_cuda")
    jag_spmm_cuda.launches += 1
    return y


jag_spmm_cuda.launches = 0


def ell_spmm_cuda(ell: BlockedELL, x):
    """y = A @ x for a float32 BlockedELL A and float32 x (N, K), kernel K4.

    One CUDA block per block row walks its W slots (padding slots hold zero
    data) and writes its output tile once. CPU tensors run
    ``sparse.bell_spmm``.
    """
    if x.device.type == "cpu":
        return bell_spmm(ell, x)
    M, N, K = _check_inputs("ell_spmm_cuda", ell, (ell.cols,), x)
    from ._build import load_library
    lib = load_library()
    y = torch.empty((M, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.indigo_ell_spmm(
            ell.data.data_ptr(), ell.cols.data_ptr(), ell.R, ell.W, ell.bm,
            x.data_ptr(), y.data_ptr(), M, N, K,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, code, "ell_spmm_cuda")
    ell_spmm_cuda.launches += 1
    return y


ell_spmm_cuda.launches = 0
