"""Compute kernels and their plain torch versions.

``dft_fft``: per-axis matrix DFTs (torch); ``tile_interp``: KB gridding
(torch); ``dft_cuda``: the Toeplitz SENSE normal op, a hand-written CUDA
kernel with its plain version; ``pad_dft_cuda``: the adjoint centered
pad-DFT of the gridding adjoint, a hand-written CUDA kernel with its plain
version; ``ell_spmm``: the block-sparse SpMM kernels
K3 (jag) and K4 (ELL); ``_build``: the nvcc/ctypes loader, which builds on
first use only. :func:`spmm` dispatches a block-sparse product;
:func:`set_spmm_impl` and :func:`use_pallas` keep the reference's names
for the choice of SpMM and for whether hand-written kernels serve.

Gradients: the kernels are linear in their operand, and each is wrapped in
an autograd Function whose backward launches the adjoint kernel (K1 and K2
are Hermitian, K3 and K4 apply the matrix's stored conjugate transpose).
K1 and K2 always launch through their Function (without grad the product
carries no graph); K3 and K4 only when the product must carry the graph,
since their solves wait on the host (``ops.ell_spmm``). On the card, a
gradient with respect to the operator's own tensors (maps, spectrum,
matrix values) is not ported and raises (:func:`_refuse_operator_grad`);
on the CPU the plain versions differentiate everything under autograd.
"""
from __future__ import annotations

import torch

__all__ = ["spmm", "use_pallas", "set_spmm_impl"]

_SPMM_IMPL = "auto"


def _refuse_operator_grad(name, **operator):
    """Raise NotImplementedError when grad mode is on and a tensor of the
    operator (``operator``: its name -> tensor or None) requires grad: a
    kernel's gradient is ported for its operand only."""
    if not torch.is_grad_enabled():
        return
    for what, t in operator.items():
        if t is not None and t.requires_grad:
            raise NotImplementedError(
                f"{name}: the gradient with respect to {what} is not ported "
                "to the card (the reference's Pallas kernel has no reverse "
                "mode either); only the operand's gradient is. Detach "
                f"{what}, or differentiate on the CPU")


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


def spmm(A, x, impl=None, AH=None):
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

    ``AH``: A's conjugate transpose in the same format, which the gradient
    in x applies with the same kernel (``ell_spmm.kernel_spmm``).
    """
    from ..sparse import BlockedJag, bell_spmm, jag_spmm
    from .ell_spmm import ell_spmm_cuda, jag_spmm_cuda, kernel_spmm

    impl = _spmm_impl(impl or _SPMM_IMPL)
    is_jag = isinstance(A, BlockedJag)
    if x.device.type == "cpu":
        return (jag_spmm if is_jag else bell_spmm)(A, x)
    if A.data.is_complex() or impl == "jnp":
        spmm.plain_cuda_calls += 1
        return (jag_spmm if is_jag else bell_spmm)(A, x)
    return kernel_spmm(jag_spmm_cuda if is_jag else ell_spmm_cuda, A, x, AH)


spmm.plain_cuda_calls = 0
