"""Multi-device scale-out: process meshes, sharded batched reconstruction.

Counterpart of ``indigo_tpu/parallel``, on ``torch.distributed``:

  * data parallel  -> 'slice' mesh axis (independent slices of a volume)
  * model parallel -> 'coil' mesh axis (the coil sum becomes a ``psum``)
  * one volume over many devices -> z slabs or (z, y) pencils: per-axis FFT
    and ``all_to_all`` transposes (``dist_fft``, ``sense_vol_recon``/``2``)
  * k-space in, image out over a mesh -> ``e2e.SenseReconSharded``

One process per device: every rank of an initialised process group calls
``make_mesh`` and then the same entry point with the same global arrays,
and gets the global result (``launch.launch`` starts such ranks on one
host; ``collectives`` holds the all_to_all / psum / psum_scatter the
solvers use).
"""
from . import collectives, launch
from .mesh import make_mesh, replicated, shard_along
from .recon import (
    sense_normal_batched, batched_cg, sense_batch_recon,
    sense_normal_volsharded, sense_vol_recon,
    sense_normal_volsharded2, sense_vol_recon2,
)
from .dist_fft import fftn_sharded, fftn_sharded2
from .e2e import SenseReconSharded, sense_recon_sharded

__all__ = [
    "make_mesh", "replicated", "shard_along",
    "sense_normal_batched", "batched_cg", "sense_batch_recon",
    "sense_normal_volsharded", "sense_vol_recon",
    "sense_normal_volsharded2", "sense_vol_recon2",
    "fftn_sharded",
    "fftn_sharded2",
    "SenseReconSharded", "sense_recon_sharded",
]
