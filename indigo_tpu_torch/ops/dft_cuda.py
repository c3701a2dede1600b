"""Toeplitz round trips on the card: CUDA kernel wrappers and plain versions.

Counterpart of ``indigo_tpu/ops/dft_pallas.py`` (``sense_normal_pallas``,
``toeplitz_apply_pallas``, ``pallas_spectrum``, ``pallas_supported``):

    K1  out_s = sum_c conj(m_c) * crop(IFFT(Tf * FFT(pad_2x(m_c * v_s))))
    K2  out_b = crop(IFFT(Tf * FFT(pad_2x(u_b))))

``sense_normal_cuda`` (K1) and ``toeplitz_apply_cuda`` (K2) launch the
hand-written kernels of ``csrc/sense_normal.cu`` on the current CUDA stream
— three kernels each, K2 being K1's family with the coil fusion turned off.
On CPU tensors they run ``sense_normal_reference`` and
``toeplitz_apply_reference``, the plain torch versions, which are also what
the kernels are compared with on the card. The kernels are built on first
use (``ops/_build.py``), never at import.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .dft_fft import block_spectrum, dft_pad2x_mats, toeplitz_apply_block

__all__ = ["kernel_spectrum", "supported", "sense_normal_reference",
           "sense_normal_cuda", "toeplitz_apply_reference",
           "toeplitz_apply_cuda"]


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


def toeplitz_apply_reference(Tf, u):
    """Plain torch version of K2, any rank: ``dft_fft.toeplitz_apply_block``
    — the function the reference holds its Pallas K2 against. Tf (*2N)
    float32 in kernel/block layout, u (B, *N) complex64. Counts its calls on
    CUDA tensors in ``toeplitz_apply_reference.cuda_calls``."""
    if u.is_cuda:
        toeplitz_apply_reference.cuda_calls += 1
    return toeplitz_apply_block(Tf, u)


toeplitz_apply_reference.cuda_calls = 0


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
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _validate(name, Tf, v, maps=None):
    """Raise on anything the kernels do not take."""
    ts = (Tf, v) if maps is None else (Tf, v, maps)
    if not (v.is_cuda and all(t.device == v.device for t in ts)):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    if v.dtype != torch.complex64 or (maps is not None
                                      and maps.dtype != torch.complex64):
        raise TypeError(f"{name}: images and maps must be complex64")
    if Tf.dtype != torch.float32:
        raise TypeError(f"{name}: Tf must be float32")
    if v.dim() != 4 or (maps is not None and (
            maps.dim() != 4 or maps.shape[1:] != v.shape[1:])):
        shapes = ", ".join(str(tuple(t.shape)) for t in ts[1:])
        raise ValueError(f"{name}: shapes {shapes}")
    vol = tuple(int(s) for s in v.shape[1:])
    if not supported(vol):
        raise ValueError(f"{name}: volume {vol} needs dims that are "
                         "multiples of 8 in [8, 256]")
    if tuple(Tf.shape) != tuple(2 * s for s in vol):
        raise ValueError(f"{name}: Tf shape {tuple(Tf.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def _run(Tf, v, maps, events):
    """Allocate t1, t2 and the output, then enqueue kernels A, B, C on the
    current stream: K1's instances with ``maps``, K2's without. Each launch
    adds one to its wrapper's count."""
    from ._build import load_library

    lib = load_library()
    fn = toeplitz_apply_cuda if maps is None else sense_normal_cuda
    S, n1, n2, n3 = (int(s) for s in v.shape)
    cc = 1 if maps is None else int(maps.shape[0])
    B = S * cc
    dev = v.device
    m = {k: a.data_ptr() for k, a in _kernel_mats(n1, n2, n3, dev).items()}
    t1 = torch.empty((B, 2 * n1, n2, n3), dtype=torch.complex64, device=dev)
    t2 = torch.empty((B, 2 * n1, 2 * n2, n3), dtype=torch.complex64,
                     device=dev)
    out = torch.empty_like(v)
    p1, p2, pv, po = t1.data_ptr(), t2.data_ptr(), v.data_ptr(), out.data_ptr()

    def launched(code, what, i):
        _check(lib, code, f"{fn.__name__} kernel {what}")
        fn.launches += 1
        if events is not None:
            events[i].record()

    # the launchers size their grids for, and launch on, the current device
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream().cuda_stream
        if events is not None:
            events[0].record()
        if maps is None:
            code = lib.indigo_toeplitz_apply_a(pv, m["mfz"], m["mfy"], p1, p2,
                                               S, n1, n2, n3, st)
        else:
            code = lib.indigo_sense_normal_a(pv, maps.data_ptr(), m["mfz"],
                                             m["mfy"], p1, p2, S, cc, n1, n2,
                                             n3, st)
        launched(code, "A", 1)
        launched(lib.indigo_sense_normal_b(p2, Tf.data_ptr(), m["mfxT"],
                                           m["mixT"], B, n1, n2, n3, st),
                 "B", 2)
        if maps is None:
            code = lib.indigo_toeplitz_apply_c(p2, p1, po, m["miy"], m["miz"],
                                               S, n1, n2, n3, st)
        else:
            code = lib.indigo_sense_normal_c(p2, p1, maps.data_ptr(), po,
                                             m["miy"], m["miz"], S, cc, n1,
                                             n2, n3, st)
        launched(code, "C", 3)
    return out


def sense_normal_cuda(Tf, maps, v, events=None):
    """Launch the CUDA Toeplitz SENSE normal op K1 (three kernels).

    Tf: (2n1, 2n2, 2n3) float32 (:func:`kernel_spectrum` layout); maps
    (nc, n1, n2, n3) and v (S, n1, n2, n3) complex64, contiguous, on one
    CUDA device. Returns (S, n1, n2, n3) complex64. CPU tensors run the
    plain version; anything else the kernels do not take raises.
    ``events``: optional 4 ``torch.cuda.Event``s recorded before kernel A
    and after each kernel, for per-kernel timing.
    """
    if v.device.type == "cpu":
        return sense_normal_reference(Tf, maps, v)
    _validate("sense_normal_cuda", Tf, v, maps)
    return _run(Tf, v, maps, events)


sense_normal_cuda.launches = 0


def toeplitz_apply_cuda(Tf, u, events=None):
    """Launch the CUDA Toeplitz round trip K2 (three kernels): the
    counterpart of ``toeplitz_apply_pallas``.

    Tf: (2n1, 2n2, 2n3) float32 (:func:`kernel_spectrum` layout); u
    (B, n1, n2, n3) complex64, contiguous, on Tf's CUDA device. Returns
    (B, n1, n2, n3) complex64. CPU tensors run the plain version; anything
    else the kernels do not take raises (a non-contiguous u is never copied
    here). ``events``: as for :func:`sense_normal_cuda`.
    """
    if u.device.type == "cpu":
        return toeplitz_apply_reference(Tf, u)
    _validate("toeplitz_apply_cuda", Tf, u)
    return _run(Tf, u, None, events)


toeplitz_apply_cuda.launches = 0
