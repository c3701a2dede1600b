"""Batched reconstruction: the SENSE normal op and per-slice CG."""
from .recon import sense_normal_batched, batched_cg, sense_batch_recon

__all__ = ["sense_normal_batched", "batched_cg", "sense_batch_recon"]
