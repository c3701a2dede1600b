"""Compute kernels and their plain torch versions.

``dft_fft``: per-axis matrix DFTs (torch); ``tile_interp``: KB gridding
(torch); ``dft_cuda``: the Toeplitz SENSE normal op, a hand-written CUDA
kernel with its plain version; ``_build``: the nvcc/ctypes loader, which
builds on first use only.
"""
