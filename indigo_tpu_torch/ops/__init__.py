"""Compute kernels and their plain torch versions.

``dft_fft``: per-axis matrix DFTs (torch); ``tile_interp``: KB gridding
(torch); ``dft_cuda``: the Toeplitz SENSE normal op, a hand-written CUDA
kernel with its plain version; ``ell_spmm``: the block-sparse SpMM kernels
K3 (jag) and K4 (ELL); ``_build``: the nvcc/ctypes loader, which builds on
first use only. :func:`spmm` dispatches a block-sparse product.
"""
from __future__ import annotations

import torch

__all__ = ["spmm"]


def spmm(A, x):
    """y = A @ x for a BlockedJag or BlockedELL A.

    CPU tensors take the plain torch version. On CUDA a real float32 matrix
    always runs its kernel (K3 for jag, K4 for ELL); there is no other
    branch. A complex x against a real matrix needs no ``[Re | Im]`` copy:
    ``view_as_real`` of a contiguous (N, K) complex64 is an (N, 2K) float32
    matrix and the real A acts on its rows, so it goes to the kernel as is
    and the result is viewed back as complex. A complex-valued matrix takes
    the plain version, as in the reference; on CUDA that choice is counted
    in ``spmm.plain_cuda_calls``.
    """
    from ..sparse import BlockedJag, bell_spmm, jag_spmm
    from .ell_spmm import ell_spmm_cuda, jag_spmm_cuda

    is_jag = isinstance(A, BlockedJag)
    if x.device.type == "cpu":
        return (jag_spmm if is_jag else bell_spmm)(A, x)
    if A.data.is_complex():
        spmm.plain_cuda_calls += 1
        return (jag_spmm if is_jag else bell_spmm)(A, x)
    kernel = jag_spmm_cuda if is_jag else ell_spmm_cuda
    if x.is_complex():
        x = x.to(torch.complex64).contiguous()
        N, K = x.shape
        y = kernel(A, torch.view_as_real(x).reshape(N, 2 * K))
        return torch.view_as_complex(y.reshape(-1, K, 2))
    return kernel(A, x.to(torch.float32).contiguous())


spmm.plain_cuda_calls = 0
