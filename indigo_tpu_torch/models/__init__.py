"""Forward models and the serving pipeline."""
from .sense import (centered_fft_op, nufft_op, sense_nufft_op,
                    cartesian_sense_op, NufftPlan)
from .recon import SenseRecon

__all__ = ["centered_fft_op", "nufft_op", "sense_nufft_op",
           "cartesian_sense_op", "NufftPlan", "SenseRecon"]
