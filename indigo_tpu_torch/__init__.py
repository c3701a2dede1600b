"""indigo_tpu_torch: the PyTorch + CUDA port of indigo_tpu.

The port keeps indigo_tpu's module names and public signatures so each
counterpart is easy to find; inside it uses PyTorch idiom: operators and
pipelines are ``nn.Module``s holding their arrays as buffers, complex data
is native complex64, and the device is explicit. It imports torch, numpy
and scipy only (never jax, never indigo_tpu).

The slices ported so far:

* the 3D CG-SENSE serving path: ``models.SenseRecon`` ->
  ``models.sense.sense_nufft_op`` (tile gridding + ``GridDFT``) ->
  ``toeplitz.toeplitz_kernel`` -> ``parallel.recon`` (``batched_cg`` on
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
  the coil fusion turned off).
"""
from . import noncart, toeplitz, utils
from .operators import CenteredDFT, Perm, Scale, SpMatrix
from .solvers import cg
from .toeplitz import ToeplitzNormal, sense_normal_toeplitz
from .utils import rand64c, rel_err

__all__ = ["utils", "noncart", "toeplitz", "rand64c", "rel_err",
           "SpMatrix", "Perm", "CenteredDFT", "Scale", "ToeplitzNormal",
           "sense_normal_toeplitz", "cg"]
