"""The work of the port's kernels, counted from shapes alone, and the
card's published peaks: frozen copies of ``indigo_tpu_torch.profiling``'s
``bound``, ``toeplitz_bound`` and ``spmm_bound``, so that a change to the
program cannot move the yardstick.

Inputs are counted as read once and the output as written once, whatever
an implementation reads again; a share of a bound can therefore not pass
100 % unless the time leaves out part of the work.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 80 GB, data sheet, at the 700 W limit: HBM3 bytes/s and
# float32 flop/s outside the tensor cores (the port's kernels run float32
# FMAs, no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and compute ``flops`` float32 operations."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def toeplitz_flops(shape, S, nc):
    """The Toeplitz SENSE normal operator on S images of ``shape`` with nc
    coil maps (nc = 0: S bare volumes): each volume's zero-aware FFT round
    trip on the doubled grid (5 N log2 N flops per N-point FFT, two per
    line per axis each way: 20, 40, 80 V log2 n for the three axes), the
    spectrum multiply (16 V) and, with maps, the map multiply and the
    conjugate-map sum (14 V)."""
    n1, n2, n3 = shape
    V = n1 * n2 * n3
    vols = S * max(nc, 1)
    fft = V * (20 * math.log2(n1) + 40 * math.log2(n2) + 80 * math.log2(n3))
    return vols * (fft + 16 * V + (14 * V if nc else 0))


def toeplitz_bound(shape, S, nc):
    """Images and maps (complex64) and the float32 spectrum of the doubled
    grid read once, the result written once, and ``toeplitz_flops``."""
    V = math.prod(shape)
    nbytes = 8 * V * (2 * S + nc) + 4 * 8 * V
    return bound(nbytes, toeplitz_flops(shape, S, nc))


def spmm_bound(nnz, rows, cols, K):
    """y = A x for a real sparse (rows, cols) matrix with nnz stored
    values and K real columns: every value and column index (4 + 4 bytes)
    and x read once, y written once (float32); 2 flops per nonzero and
    column."""
    return bound(8 * nnz + 4 * K * (cols + rows), 2 * nnz * K)
