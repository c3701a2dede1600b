"""Profiling, timing and roofline reporting on one NVIDIA H100.

Counterpart of ``indigo_tpu/profiling.py`` with the H100's figures in place
of the TPU's: ``trace`` is a ``torch.profiler`` context that writes a Chrome
trace; ``time_apply`` and ``measure_hbm_bandwidth`` keep the reference's
k1/k2 differencing (two chains of k1 and k2 steps, each enqueued without a
host sync inside it, so what is paid once per chain cancels) and time with
CUDA events on the card, the host clock on the CPU; ``roofline_report``
keeps the reference's text and keys.

The bytes and flop models here are the port's own and are the single source
of the bounds ``chip_smoke.py`` prints: ``bound`` (the larger of bytes over
the memory rate and flops over the f32 rate), ``pass_bytes`` and
``toeplitz_bound`` for the three passes of kernels K1/K2
(``csrc/sense_normal.cu``), ``spmm_bound`` for K3/K4 (``csrc/block_spmm.cu``),
``toeplitz_cg_iter_bytes``/``_macs`` for one CG iteration on K1, and
``tile_adj_floor`` for the ``kb_scatter`` gridding adjoint.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .analyses import apply_cost
from .operators import Operator
from .solvers import _place

__all__ = ["trace", "time_apply", "roofline_report", "HBM_BYTES_PER_SEC",
           "GATHER_SEC_PER_ROW",
           "MXU_MACS_PER_SEC", "toeplitz_cg_iter_bytes",
           "toeplitz_cg_iter_macs", "tile_adj_floor",
           "measure_hbm_bandwidth"]

# NVIDIA H100 SXM published peaks (data sheet, 700 W): HBM3 bytes/s and
# f32 flop/s on the CUDA cores (the port's kernels run f32 FMAs, no tensor
# cores). ``measure_hbm_bandwidth`` gives the achievable copy rate.
HBM_BYTES_PER_SEC = 3.35e12
F32_FLOPS_PER_SEC = 67e12
# The reference's compute-axis name: here the f32 FMA (multiply-add) rate.
MXU_MACS_PER_SEC = F32_FLOPS_PER_SEC / 2

# Seconds per row of a random row gather (``index_select`` of 8-byte rows,
# 2^24 random indices into 2^25 rows, a 256 MB table past the L2 cache),
# measured by ``chip_smoke.py`` phase 10 on NVIDIA H100 80GB HBM3,
# 700.00 W. Gather-shaped work is bound by max(bytes / HBM rate,
# rows * this).
GATHER_SEC_PER_ROW = 3.445e-11


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and compute ``flops`` f32 operations."""
    tb, tf = nbytes / HBM_BYTES_PER_SEC, flops / F32_FLOPS_PER_SEC
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _toeplitz_flops(shape, S, nc):
    """Flops of K1 (nc maps, S images) or K2 (nc = 0, S volumes): the
    zero-aware FFT round trip of every volume it transforms (5 N log2 N
    flops per N-point FFT, two per line per axis each way: 20, 40, 80 V
    log2 n for z, y, x), the spectrum multiply and, for K1, the map
    multiply and conj-map sum."""
    n1, n2, n3 = shape
    V = n1 * n2 * n3
    vols = S * max(nc, 1)
    fft = V * (20 * np.log2(n1) + 40 * np.log2(n2) + 80 * np.log2(n3))
    return vols * (fft + 16 * V + (14 * V if nc else 0))


def toeplitz_bound(shape, S, nc):
    """K1 (nc maps, S images) or K2 (nc = 0, S volumes): inputs read and the
    output written once, and ``_toeplitz_flops``."""
    V = int(np.prod(shape))
    nbytes = 8 * V * (2 * S + nc) + 4 * 8 * V
    return bound(nbytes, _toeplitz_flops(shape, S, nc))


def pass_bytes(shape, S, nc):
    """Bytes each of the three passes (z forward, plane, z inverse) moves
    when it reads its inputs once and writes its output once: v and maps
    -> t1 (2V per volume) -> t1 and the f32 spectrum (8V floats) -> t1
    -> out."""
    V = int(np.prod(shape))
    vols = S * max(nc, 1)
    return [8 * V * (S + nc + 2 * vols), 8 * V * 4 * vols + 32 * V,
            8 * V * (2 * vols + nc + S)]


def spmm_bound(csr, K):
    """y = A x with K real columns: every nonzero (value and column index)
    and x read once, y written once; 2 flops per nonzero and column."""
    M, Nc = csr.shape
    return bound(8 * csr.nnz + 4 * K * (Nc + M), 2 * csr.nnz * K)


def toeplitz_cg_iter_bytes(img_shape, nc, layout, coil_chunk=None):
    """Minimum memory traffic (bytes) of ONE Toeplitz-SENSE CG iteration.

    ``layout="kernel"`` (the reference's ``"pallas"`` is a synonym): one
    normal-op call of K1 per coil chunk, each the sum of its three passes'
    ``pass_bytes`` (maps, image and spectrum read once per chunk), plus
    the CG vector updates (6 image-size passes: Ap read/write, x/r/p
    updates) and, with several chunks, their sum (read 2V, write V per
    chunk after the first). Other layouts (``"block"``, ``"fft"``: one
    transform per coil, unfused) keep the reference's model: per axis read
    V write 2V growing 1 -> 8V forward and mirrored back (42V per coil),
    the spectrum per chunk, the unfused coil multiply/combine (4V per
    coil) and the CG vector updates.
    """
    npx = int(np.prod(img_shape))
    nchunks = max(1, nc // coil_chunk) if coil_chunk else 1
    if layout in ("kernel", "pallas"):
        per_call = sum(pass_bytes(img_shape, 1, nc // nchunks))
        return nchunks * per_call + (6 + 3 * (nchunks - 1)) * npx * 8
    big = int(np.prod([2 * s for s in img_shape]))
    fft_bytes = 42 * npx * nc * 8 + big * 4 * nchunks
    return fft_bytes + (4 * npx * nc + 6 * npx) * 8


def toeplitz_cg_iter_macs(img_shape, nc):
    """f32 multiply-adds of ONE Toeplitz-SENSE CG iteration on K1 (half of
    the flops ``toeplitz_bound`` counts for one image and nc maps): the
    compute axis of the roofline, against ``MXU_MACS_PER_SEC``."""
    return _toeplitz_flops(tuple(img_shape), 1, nc) / 2


def tile_adj_floor(plan, K):
    """Three-resource speed-of-light (seconds) for ONE gridding adjoint
    apply through ``ops.tile_interp.kb_scatter`` (the port's G^H on the
    natural-order grid; the reference's binned layout is not ported) at K
    f32 columns (complex K' columns are K = 2K').

    The terms mirror the implementation stage for stage, with E = M w^d
    patch entries (M samples, width w, d axes):

    * rows: one ``index_add_`` row per entry, at GATHER_SEC_PER_ROW.
    * bytes: zero the (N, K) grid; read the patches (corners, weights) and
      the samples; write the expanded node ids (8 B) and weights (4 B) per
      entry, each read back once (the weights by the multiply, the ids by
      the ``index_add_``); write the weighted rows (K f32 per entry), which
      the ``index_add_`` reads, reading and writing one grid row per entry.
    * flops: one multiply (the weight) and one add per entry and column.

    Returns (floor_seconds, dict of per-term seconds).
    """
    nd = len(plan.grid_shape)
    M = int(plan.n_samples)
    E = M * plan.width ** nd
    N = int(np.prod(plan.grid_shape))
    stream = (4 * N * K                                  # zero the grid
              + M * nd * (8 + 4 * plan.width) + 4 * M * K  # patches, samples
              + 2 * 12 * E                               # ids and weights
              + 2 * 4 * E * K                            # weighted rows
              + 2 * 4 * E * K)                           # grid rows r/w
    terms = {"rows": E * GATHER_SEC_PER_ROW,
             "hbm": stream / HBM_BYTES_PER_SEC,
             "flops": 2 * E * K / F32_FLOPS_PER_SEC}
    return max(terms.values()), terms


def _chain_seconds(step, k, device):
    """Seconds of k calls of ``step`` enqueued back to back: CUDA events on
    the card (no host sync inside the chain), the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(k):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        step()
    return time.perf_counter() - t0


def measure_hbm_bandwidth(nbytes=1 << 29, k1=4, k2=12, device=None):
    """Measured achievable memory bandwidth (bytes/sec) on ``device`` (by
    default the card): an in-place x += 1 pass over ``nbytes`` of f32 (read
    V + write V per step), timed by step differencing (what a chain pays
    once cancels)."""
    device = _place(None, device)
    x = torch.zeros(nbytes // 4, dtype=torch.float32, device=device)
    step = lambda: x.add_(1.0)  # noqa: E731
    _chain_seconds(step, k1, device)
    _chain_seconds(step, k2, device)  # warm both chain lengths
    ds = [_chain_seconds(step, k2, device) - _chain_seconds(step, k1, device)
          for _ in range(3)]
    per_pass = max(float(np.median(ds)) / (k2 - k1), 1e-12)
    return 2.0 * x.numel() * 4 / per_pass


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace (host, and the card's kernels
    where there is one) into ``logdir/trace.json``, a Chrome trace (view
    with Perfetto or chrome://tracing). Yields the profiler.

    The trace carries the program's layer spans (``tracing``: ``indigo.rhs``,
    ``indigo.solve``, ``indigo.cg_iter``, ...) as host events beside the
    operators; ``tracing.spans()`` holds the same spans in memory, with
    their device ms."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(str(logdir), exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def time_apply(op: Operator, ncols=1, k1=2, k2=6, adjoint_pair=True,
               seed=0, device=None):
    """Seconds per operator apply, by differencing.

    Runs chains of k1 and k2 chained applies, each enqueued without a host
    sync inside it, and reports (t(k2) - t(k1)) / (k2 - k1): the upload,
    the final sync and what a chain pays once cancel. With adjoint_pair=True
    each "apply" is a forward+adjoint pair (required when op is non-square
    so shapes chain), and the result is per single apply. The operator runs
    where it lives; ``device`` (default: the operator's device, else the
    card) places the input.
    """
    if op.shape[0] != op.shape[1] and not adjoint_pair:
        raise ValueError("non-square operator needs adjoint_pair=True")
    device = _place(op, device)
    rng = np.random.default_rng(seed)
    n = op.shape[1]
    x = torch.from_numpy(
        (rng.standard_normal((n, ncols), dtype=np.float32)
         + 1j * rng.standard_normal((n, ncols), dtype=np.float32)
         ).astype(np.complex64)).to(device)
    state = [x]

    def step():
        y = op.apply(state[0])
        state[0] = op.apply(y, adjoint=True) if adjoint_pair else y

    with torch.no_grad():
        _chain_seconds(step, k1, device)
        _chain_seconds(step, k2, device)  # warm both chain lengths
        t1 = _chain_seconds(step, k1, device)
        t2 = _chain_seconds(step, k2, device)
    per = max((t2 - t1) / (k2 - k1), 1e-12)
    return per / (2 if adjoint_pair else 1)


def roofline_report(op: Operator, ncols=1, measure=True, device=None):
    """Per-apply FLOPs/bytes estimate and (optionally) measured time vs the
    HBM speed-of-light (north star: 'per-apply time at roofline');
    ``device`` as in :func:`time_apply`."""
    flops, bytes_ = apply_cost(op, ncols)
    sol = bytes_ / HBM_BYTES_PER_SEC
    lines = [
        f"operator: {op.name} {op.shape} x {ncols} cols",
        f"est. flops/apply:  {flops:,}",
        f"est. bytes/apply:  {bytes_:,}",
        f"HBM speed-of-light: {sol*1e3:.3f} ms",
    ]
    result = {"flops": flops, "bytes": bytes_, "sol_sec": sol}
    if measure:
        t = time_apply(op, ncols, device=device)
        result["measured_sec"] = t
        result["roofline_frac"] = sol / t if t else 0.0
        lines += [
            f"measured/apply:    {t*1e3:.3f} ms",
            f"roofline fraction: {100*result['roofline_frac']:.1f}%",
        ]
    return result, "\n".join(lines)
