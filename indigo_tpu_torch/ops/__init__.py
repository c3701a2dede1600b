"""Compute kernels and their plain torch versions.

``dft_fft``: per-axis matrix DFTs (torch); ``tile_interp``: KB gridding
(torch); ``dft_cuda``: the Toeplitz SENSE normal op, a hand-written CUDA
kernel with its plain version; ``ell_spmm``: the block-sparse SpMM kernels
K3 (jag) and K4 (ELL); ``_build``: the nvcc/ctypes loader, which builds on
first use only. :func:`spmm` dispatches a block-sparse product;
:func:`set_spmm_impl` and :func:`use_pallas` keep the reference's names
for the choice of SpMM and for whether hand-written kernels serve.
"""
from __future__ import annotations

import torch

__all__ = ["spmm", "use_pallas", "set_spmm_impl"]

_SPMM_IMPL = "auto"


def _spmm_impl(impl):
    if impl not in ("auto", "jnp", "pallas"):
        raise ValueError(f"unknown SpMM impl {impl!r}")
    return impl


def set_spmm_impl(impl):
    """Select the SpMM implementation on CUDA: 'auto' | 'pallas' | 'jnp'.

    The reference's names: 'auto' and 'pallas' both run the hand-written
    kernel (K3 or K4); 'jnp' asks for the plain torch version, and each
    such call on CUDA counts in ``spmm.plain_cuda_calls``. Nothing in the
    package sets it; CPU tensors take the plain version whatever it says.
    """
    global _SPMM_IMPL
    _SPMM_IMPL = _spmm_impl(impl)


def use_pallas():
    """True when the hand-written kernels serve: when a card is present
    (the reference's name, where it means a TPU)."""
    return torch.cuda.is_available()


def spmm(A, x, impl=None):
    """y = A @ x for a BlockedJag or BlockedELL A.

    CPU tensors take the plain torch version. On CUDA a real float32 matrix
    runs its kernel (K3 for jag, K4 for ELL) unless ``impl`` (by default
    what :func:`set_spmm_impl` chose) is 'jnp'. A complex x against a real
    matrix needs no ``[Re | Im]`` copy:
    ``view_as_real`` of a contiguous (N, K) complex64 is an (N, 2K) float32
    matrix and the real A acts on its rows, so it goes to the kernel as is
    and the result is viewed back as complex. A complex-valued matrix takes
    the plain version, as in the reference. On CUDA each call of the plain
    version, for either reason, is counted in ``spmm.plain_cuda_calls``.
    """
    from ..sparse import BlockedJag, bell_spmm, jag_spmm
    from .ell_spmm import ell_spmm_cuda, jag_spmm_cuda

    impl = _spmm_impl(impl or _SPMM_IMPL)
    is_jag = isinstance(A, BlockedJag)
    if x.device.type == "cpu":
        return (jag_spmm if is_jag else bell_spmm)(A, x)
    if A.data.is_complex() or impl == "jnp":
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
