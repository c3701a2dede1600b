"""The reference's five example scripts on the port, one per configuration.

Each runs on the card unless asked for the CPU and returns the numbers it
prints as a dict::

    python -m indigo_tpu_torch.examples.cartesian_sense_2d [--cpu]
    python -m indigo_tpu_torch.examples.radial_sense_2d [--cpu]
    python -m indigo_tpu_torch.examples.multicoil_3d [--big] [--cpu]
    python -m indigo_tpu_torch.examples.cs_wavelet_fista [--cpu]
    python -m indigo_tpu_torch.examples.serving_pipeline [--big] [--cpu]

``README.md`` beside them gives their results on one H100.
"""
