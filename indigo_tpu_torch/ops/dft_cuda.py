"""Toeplitz SENSE normal operator: CUDA kernel wrapper and its plain version.

Counterpart of ``indigo_tpu/ops/dft_pallas.py`` (``sense_normal_pallas``,
``pallas_spectrum``, ``pallas_supported``):

    out_s = sum_c conj(m_c) * crop(IFFT(Tf * FFT(pad_2x(m_c * v_s))))

``sense_normal_cuda`` launches the three hand-written kernels of
``csrc/sense_normal.cu`` on the current CUDA stream; on CPU tensors it runs
``sense_normal_reference``, the plain torch version, which is also what the
kernel is compared with on the card. The kernels are built on first use
(``ops/_build.py``), never at import.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .dft_fft import block_spectrum, dft_pad2x_mats, toeplitz_apply_block

__all__ = ["kernel_spectrum", "supported", "sense_normal_reference",
           "sense_normal_cuda"]


def kernel_spectrum(Tf: np.ndarray) -> np.ndarray:
    """Host-side: raw doubled-grid spectrum (Z, Y, X) -> the layout the CUDA
    kernel reads: block (even|odd) order on every axis, axes kept in
    (Z, Y, X) order with X contiguous — the same array as
    :func:`block_spectrum`, so the plain version reads it unchanged."""
    return block_spectrum(np.asarray(Tf, dtype=np.float32))


def supported(shape) -> bool:
    """True when the kernels take this volume: 3D, every dim a multiple of
    8 and in [8, 256] (kernel B keeps 16 doubled x-lines in 96 KB of shared
    memory at n3 = 256)."""
    if len(shape) != 3:
        return False
    return all(s % 8 == 0 and 8 <= s <= 256 for s in shape)


def sense_normal_reference(Tf, maps, v):
    """Plain torch version, any rank: Tf (*2N) float32 in kernel/block
    layout, maps (nc, *N) and v (S, *N) complex64. Counts its calls on
    CUDA tensors in ``sense_normal_reference.cuda_calls``."""
    if v.is_cuda:
        sense_normal_reference.cuda_calls += 1
    S = v.shape[0]
    nc = maps.shape[0]
    img = tuple(v.shape[1:])
    u = maps[None] * v[:, None]
    u = toeplitz_apply_block(Tf, u.reshape((S * nc,) + img))
    u = u.reshape((S, nc) + img)
    return torch.sum(maps.conj()[None] * u, dim=1)


sense_normal_reference.cuda_calls = 0


@lru_cache(maxsize=16)
def _kernel_mats(n1, n2, n3, device):
    """The six stage matrices in the orientation each kernel reads."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mfz, miz = dft_pad2x_mats(n1)
    mfy, miy = dft_pad2x_mats(n2)
    mfx, mix = dft_pad2x_mats(n3)
    return {"mfz": t(mfz), "mfy": t(mfy), "mfxT": t(mfx.T),
            "mixT": t(mix.T), "miy": t(miy), "miz": t(miz)}


def _check(lib, code, what):
    if code != 0:
        msg = lib.indigo_error_string(code).decode()
        raise RuntimeError(f"sense_normal kernel {what}: CUDA error "
                           f"{code} ({msg})")


def _launch(lib, mats, Tf, maps, v, t1, t2, out, events):
    """Enqueue kernels A, B, C on the current stream, counting each launch."""
    S, n1, n2, n3 = v.shape
    cc = maps.shape[0]
    B = S * cc
    stream = torch.cuda.current_stream().cuda_stream

    def mark(i):
        if events is not None:
            events[i].record()

    mark(0)
    _check(lib, lib.indigo_sense_normal_a(
        v.data_ptr(), maps.data_ptr(), mats["mfz"].data_ptr(),
        mats["mfy"].data_ptr(), t1.data_ptr(), t2.data_ptr(),
        S, cc, n1, n2, n3, stream), "A")
    sense_normal_cuda.launches += 1
    mark(1)
    _check(lib, lib.indigo_sense_normal_b(
        t2.data_ptr(), Tf.data_ptr(), mats["mfxT"].data_ptr(),
        mats["mixT"].data_ptr(), B, n1, n2, n3, stream), "B")
    sense_normal_cuda.launches += 1
    mark(2)
    _check(lib, lib.indigo_sense_normal_c(
        t2.data_ptr(), t1.data_ptr(), maps.data_ptr(), out.data_ptr(),
        mats["miy"].data_ptr(), mats["miz"].data_ptr(),
        S, cc, n1, n2, n3, stream), "C")
    sense_normal_cuda.launches += 1
    mark(3)


def sense_normal_cuda(Tf, maps, v, events=None):
    """Launch the CUDA Toeplitz SENSE normal op (three kernels).

    Tf: (2n1, 2n2, 2n3) float32 (:func:`kernel_spectrum` layout); maps
    (nc, n1, n2, n3) and v (S, n1, n2, n3) complex64, contiguous, on one
    CUDA device. Returns (S, n1, n2, n3) complex64. CPU tensors run the
    plain version; anything else the kernels do not take raises.
    ``events``: optional 4 ``torch.cuda.Event``s recorded before kernel A
    and after each kernel, for per-kernel timing.
    """
    if v.device.type == "cpu":
        return sense_normal_reference(Tf, maps, v)
    if not (v.is_cuda and maps.device == v.device and Tf.device == v.device):
        raise ValueError("sense_normal_cuda: Tf, maps and v must share one "
                         "CUDA device")
    if v.dtype != torch.complex64 or maps.dtype != torch.complex64:
        raise TypeError("sense_normal_cuda: v and maps must be complex64")
    if Tf.dtype != torch.float32:
        raise TypeError("sense_normal_cuda: Tf must be float32")
    if v.dim() != 4 or maps.dim() != 4 or maps.shape[1:] != v.shape[1:]:
        raise ValueError(f"sense_normal_cuda: shapes v {tuple(v.shape)}, "
                         f"maps {tuple(maps.shape)}")
    S, n1, n2, n3 = (int(s) for s in v.shape)
    cc = int(maps.shape[0])
    if not supported((n1, n2, n3)):
        raise ValueError(f"sense_normal_cuda: volume {(n1, n2, n3)} needs "
                         "dims that are multiples of 8 in [8, 256]")
    if tuple(Tf.shape) != (2 * n1, 2 * n2, 2 * n3):
        raise ValueError(f"sense_normal_cuda: Tf shape {tuple(Tf.shape)}")
    if not (v.is_contiguous() and maps.is_contiguous()
            and Tf.is_contiguous()):
        raise ValueError("sense_normal_cuda: inputs must be contiguous")

    from ._build import load_library
    lib = load_library()
    dev = v.device
    mats = _kernel_mats(n1, n2, n3, dev)
    B = S * cc
    t1 = torch.empty((B, 2 * n1, n2, n3), dtype=torch.complex64, device=dev)
    t2 = torch.empty((B, 2 * n1, 2 * n2, n3), dtype=torch.complex64,
                     device=dev)
    out = torch.empty_like(v)

    # the launchers size their grids for, and launch on, the current device
    with torch.cuda.device(dev):
        _launch(lib, mats, Tf, maps, v, t1, t2, out, events)
    return out


sense_normal_cuda.launches = 0
