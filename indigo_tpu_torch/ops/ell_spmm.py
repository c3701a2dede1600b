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

A bare wrapper call knows no adjoint, so on the card it raises when x or
the matrix values require grad; :func:`kernel_spmm`, the card's route of
``ops.spmm(A, x, AH=...)`` and so of ``SpMatrix``, differentiates in x
through :class:`_SpmmFn`, and only where the product must carry the graph
(:func:`_carries_graph`): on the H100 a launch through the Function costs
34-116 us more host time, 2.1-7.2 ms on a 44-85 ms radial CG solve, which
waits on the host (``chip_smoke.py``, phase 12d).
"""
from __future__ import annotations

from functools import partial

import torch
from torch.autograd.function import once_differentiable

from . import _refuse_operator_grad
from ..sparse import BlockedELL, BlockedJag, bell_spmm, jag_spmm

__all__ = ["jag_spmm_cuda", "ell_spmm_cuda", "kernel_spmm"]


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


def _carries_graph(x):
    """True when a product of x must carry autograd's graph."""
    return x.requires_grad and torch.is_grad_enabled()


def _launch(name, entry, A, x):
    """Check, allocate y, launch ``entry`` on the current stream. Inside
    :class:`_SpmmFn` grad mode is off, so only a bare call refuses (the
    test is spelled out: phase 12d forces :func:`_carries_graph`)."""
    _refuse_operator_grad(name, data=A.data, nz_val=A.nz_val)
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: x requires grad, and a bare call has no adjoint "
            "matrix to launch for it; apply an SpMatrix, or call "
            "ops.spmm(A, x, AH=...)")
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


class _SpmmFn(torch.autograd.Function):
    """y = A x, differentiable in x: forward ``kernel(A, x)``, backward
    ``kernel(AH, g)`` with AH = A^H stored beside A (for the real f32
    matrices the kernels take, A^T). ``kernel`` is ``jag_spmm_cuda`` or
    ``ell_spmm_cuda``, which take the plain version on CPU tensors, so the
    CPU tests run this wiring too."""

    @staticmethod
    def forward(ctx, kernel, A, AH, x):
        ctx.kernel, ctx.AH = kernel, AH
        return kernel(A, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, None, ctx.kernel(ctx.AH, g.contiguous())


def kernel_spmm(kernel, A, x, AH=None):
    """y = A x through ``kernel`` (:func:`jag_spmm_cuda` or
    :func:`ell_spmm_cuda`) for a real A: ``ops.spmm``'s route on the card.

    A complex x goes to the kernel as the (N, 2K) float32 view of its real
    and imaginary parts and comes back complex. Given ``AH`` = A^H and an
    x whose product carries the graph, it runs through :class:`_SpmmFn`,
    whose backward launches ``kernel`` on ``AH``; matrix values that
    require grad raise. Otherwise it is a bare kernel call, which on the
    card raises for an x that requires grad. On CPU tensors the wrappers
    take their plain versions, so the tests run this route there.
    """
    if AH is not None and _carries_graph(x):
        _refuse_operator_grad("spmm", data=A.data, nz_val=A.nz_val)
        run = partial(_SpmmFn.apply, kernel, A, AH)
    else:
        run = partial(kernel, A)  # refuses what it cannot differentiate
    if x.is_complex():
        x = x.to(torch.complex64).contiguous()
        N, K = x.shape
        y = run(torch.view_as_real(x).reshape(N, 2 * K))
        return torch.view_as_complex(y.reshape(-1, K, 2))
    return run(x.to(torch.float32).contiguous())
