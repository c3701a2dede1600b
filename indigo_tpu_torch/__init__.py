"""indigo_tpu_torch: the PyTorch + CUDA port of indigo_tpu.

The port keeps indigo_tpu's module names and public signatures so each
counterpart is easy to find; inside it uses PyTorch idiom: operators and
pipelines are ``nn.Module``s holding their arrays as buffers, complex data
is native complex64, and the device is explicit. Its boundary is the
reference's: host data is narrowed to 32-bit as ``jnp.asarray`` narrows it
and goes to the card unless ``device=`` names another
(``utils.as_tensor``). It imports torch, numpy and scipy only (never jax,
never indigo_tpu).

The slices ported so far:

* the 3D CG-SENSE serving path: ``models.SenseRecon`` ->
  ``models.sense.sense_nufft_op`` (tile gridding + ``GridDFT``, or
  ``KBInterp * CenteredDFT`` on grids the periodic tiling does not cover)
  -> ``toeplitz.toeplitz_kernel`` -> ``parallel.recon`` (``batched_cg`` on
  ``sense_normal_batched``), whose normal operator runs the hand-written
  CUDA kernel in ``csrc/sense_normal.cu`` on the GPU;
* the sparse-gridding path: ``sense_nufft_op(..., interp="sparse")``
  (``SpMatrix`` . ``Perm`` . ``CenteredDFT``) solved with ``cg`` on the
  operator algebra, whose gridding SpMMs run the hand-written CUDA kernels
  K3 (jag) and K4 (blocked-ELL) in ``csrc/block_spmm.cu``;
* the Toeplitz normal operator in the operator algebra:
  ``toeplitz.ToeplitzNormal`` and ``sense_normal_toeplitz`` solved with
  ``cg``, with ``noncart.pipe_menon_dcf`` weights; its 3D apply runs the
  hand-written CUDA kernel K2 (``csrc/sense_normal.cu``, K1's family with
  the coil fusion turned off);
* the Cartesian path with the tree optimizer:
  ``models.cartesian_sense_op`` (``Mask`` . ``centered_fft_op``),
  ``transforms.optimize`` / ``Operator.optimize()`` (the host spGEMM pass
  that fuses ``Mask.H * Mask`` into one ``Diag``) and ``cg``;
* l1-wavelet compressed sensing: ``wavelet.DWT`` with ``solvers.apgd``
  (FISTA), ``max_eigen`` and ``soft_thresh``.
  These two paths are torch code throughout (``torch.fft``, gathers, small
  matrix products), as the reference runs them without a hand-written
  kernel;
* the multi-device paths over a ``torch.distributed`` mesh (``parallel``):
  ``make_mesh``, slab and pencil ``fftn_sharded``/``fftn_sharded2``,
  ``sense_batch_recon(mesh=)`` (slices x coils, K1 on every rank's block),
  ``sense_vol_recon``/``sense_vol_recon2`` (one volume in z slabs or
  pencils) and ``SenseReconSharded`` (k-space in, image out), with
  ``parallel.launch`` to start the ranks on one host.

The whole operator algebra of the reference is here (``operators``); its
float64 numpy spec is ``oracle``. So are the rest of its modules: the
native C++ gridding code (``native``, behind ``noncart.interp_mat``),
the reference-shaped backend facade (``backends``: ``get_backend``),
timing and H100 roofline floors (``profiling``), solver-state
checkpoints (``checkpoint``) and the five example scripts
(``python -m indigo_tpu_torch.examples.<name>``).
"""
# The reference's ``cplx`` (split re/im planes at its device boundary) has
# no counterpart: torch holds complex64 on the card.
from . import (operators, transforms, analyses, solvers, sparse, utils,
               noncart, oracle, models, wavelet, toeplitz, parallel, backends,
               native, profiling, checkpoint)
from .backends import get_backend, available_backends
from .operators import (
    Operator, SpMatrix, KBInterp, DenseMatrix, Diag, UnscaledFFT,
    CenteredDFT, GridDFT, Eye, One, Mask,
    CropPad, Perm, Product, Adjoint, KronI, BlockDiag, VStack, HStack, Scale,
)
from .solvers import cg, apgd, fista, max_eigen, soft_thresh
from .wavelet import DWT
from .sparse import BlockedELL, csr_to_bell, bell_spmm
from .toeplitz import ToeplitzNormal, sense_normal_toeplitz
from .utils import rand64c, rel_err

__all__ = [
    "operators", "transforms", "analyses", "solvers", "sparse", "utils",
    "noncart",
    "oracle", "models", "wavelet", "toeplitz", "parallel", "backends",
    "native", "profiling", "checkpoint", "get_backend", "available_backends",
    "Operator", "SpMatrix", "KBInterp", "DenseMatrix", "Diag", "UnscaledFFT",
    "CenteredDFT", "GridDFT", "Eye", "One", "Mask", "CropPad", "Perm",
    "Product", "Adjoint", "KronI", "BlockDiag", "VStack", "HStack", "Scale",
    "cg", "apgd", "fista", "max_eigen", "soft_thresh", "DWT",
    "BlockedELL", "csr_to_bell", "bell_spmm",
    "ToeplitzNormal", "sense_normal_toeplitz", "rand64c", "rel_err",
]

__version__ = "0.1.0"
