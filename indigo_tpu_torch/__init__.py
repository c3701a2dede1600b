"""indigo_tpu_torch: the PyTorch + CUDA port of indigo_tpu.

The port keeps indigo_tpu's module names and public signatures so each
counterpart is easy to find; inside it uses PyTorch idiom: operators and
pipelines are ``nn.Module``s holding their arrays as buffers, complex data
is native complex64, and the device is explicit. It imports torch, numpy
and scipy only (never jax, never indigo_tpu).

The slice ported so far is the 3D CG-SENSE serving path:
``models.SenseRecon`` -> ``models.sense.sense_nufft_op`` (tile gridding +
``GridDFT``) -> ``toeplitz.toeplitz_kernel`` -> ``parallel.recon``
(``batched_cg`` on ``sense_normal_batched``), whose normal operator runs the
hand-written CUDA kernel in ``csrc/sense_normal.cu`` on the GPU.
"""
from . import utils
from .utils import rand64c, rel_err

__all__ = ["utils", "rand64c", "rel_err"]
