"""Forward models and the serving pipeline."""
from .sense import nufft_op, sense_nufft_op, NufftPlan
from .recon import SenseRecon

__all__ = ["nufft_op", "sense_nufft_op", "NufftPlan", "SenseRecon"]
