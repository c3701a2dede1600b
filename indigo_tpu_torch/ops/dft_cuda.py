"""Toeplitz round trips on the card: CUDA kernel wrappers and plain versions.

Counterpart of ``indigo_tpu/ops/dft_pallas.py`` (``sense_normal_pallas``,
``toeplitz_apply_pallas``, ``pallas_spectrum``, ``pallas_supported``):

    K1  out_s = sum_c conj(m_c) * crop(IFFT(Tf * FFT(pad_2x(m_c * v_s))))
    K2  out_b = crop(IFFT(Tf * FFT(pad_2x(u_b))))

``sense_normal_cuda`` (K1) and ``toeplitz_apply_cuda`` (K2) launch the
hand-written kernels of ``csrc/sense_normal.cu`` on the current CUDA stream
— three passes each (``LAUNCHES_PER_CALL``): the z forward, the plane pass
(y forward, x round trip with the spectrum, y inverse, for each z-frequency
plane, its y-spectrum held in a ring of planes that stays in L2) and the z
inverse, K2 being K1's family with the coil fusion turned off. Every
transform is a two-factor FFT in shared memory whose factors and twiddle
table come from :func:`fft_factors` and :func:`fft_table`;
:func:`four_step` applies the same transform in torch, in the kernels'
index order, and :func:`plane_pass` the plane pass's decomposition, for
the CPU tests. On CPU tensors they run ``sense_normal_reference`` and
``toeplitz_apply_reference``, the plain torch versions, which are also what
the kernels are compared with on the card. The kernels are built on first
use (``ops/_build.py``), never at import.

Both operators are Hermitian (a real spectrum; the coil sum is
sum_c conj(m_c) T(m_c .)), so the gradient in the operand is one more
launch of the same kernel on the cotangent (:class:`_SenseNormalFn`). On
the card the wrappers always launch through it; a spectrum or maps that
require grad raise there (not ported, as in the reference's kernels).

The reference's sigma-basis helpers (``uses_sigma_basis``,
``solver_sigma_axes``, ``to_sigma_basis``, ``from_sigma_basis``) are here
with its semantics, as index permutations of tensors: its kernels work in
an even | odd block order on every axis longer than 128, and its solvers
may hold their state in that order. The CUDA kernels work in natural
order, so the port uses the basis only at its boundary
(``parallel.sense_normal_batched(sigma=True)``,
``ToeplitzNormal.sigma_basis``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import tracing
from . import _refuse_operator_grad
from .dft_fft import block_spectrum, toeplitz_apply_block

__all__ = ["kernel_spectrum", "supported", "kernel_serves",
           "sense_normal_reference",
           "sense_normal_cuda", "toeplitz_apply_reference",
           "toeplitz_apply_cuda", "fft_factors", "fft_table",
           "fft_positions", "four_step", "plane_pass", "LAUNCHES_PER_CALL",
           "uses_sigma_basis", "solver_sigma_axes", "to_sigma_basis",
           "from_sigma_basis"]

LAUNCHES_PER_CALL = 3  # kernel launches per sense_normal_cuda / K2 call


def kernel_spectrum(Tf: np.ndarray) -> np.ndarray:
    """Host-side: raw doubled-grid spectrum (Z, Y, X) -> the layout the CUDA
    kernel reads: block (even|odd) order on every axis, axes kept in
    (Z, Y, X) order with X contiguous — the same array as
    :func:`block_spectrum`, so the plain version reads it unchanged."""
    return block_spectrum(np.asarray(Tf, dtype=np.float32))


def supported(shape) -> bool:
    """True when the kernels take this volume: 3D, every dim a multiple of
    8 and in [8, 256] (n = p q with p in {8, 16} and q <= 32; a pencil
    bundle of 256 rows x 16 columns, both halves, fills 70 KB of shared
    memory)."""
    if len(shape) != 3:
        return False
    return all(s % 8 == 0 and 8 <= s <= 256 for s in shape)


def kernel_serves(shape, device) -> bool:
    """True when K1/K2 serve a volume of this shape on ``device``: a CUDA
    device and a shape that :func:`supported` takes."""
    return torch.device(device).type == "cuda" and supported(shape)


def uses_sigma_basis(shape) -> bool:
    """True when the reference's kernels would hold this volume in the
    sigma basis: 3D with an axis longer than 128."""
    return len(shape) == 3 and any(int(s) > 128 for s in shape)


def _sigma_axes(shape):
    """The axes that the sigma basis reorders: those longer than 128."""
    return tuple(i for i, s in enumerate(shape) if int(s) > 128)


def solver_sigma_axes(img_shape, lead=1):
    """The sigma axes of a batched (lead, *img_shape) array."""
    return tuple(lead + ax for ax in _sigma_axes(img_shape))


def _sigma_order(n):
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])


def to_sigma_basis(a, img_axes):
    """Reorder ``img_axes`` of ``a`` from natural order to the sigma basis
    (the even entries, then the odd ones)."""
    from ..utils import as_tensor

    a = as_tensor(a)
    for ax in img_axes:
        idx = torch.from_numpy(_sigma_order(a.shape[ax])).to(a.device)
        a = a.index_select(ax, idx)
    return a


def from_sigma_basis(a, img_axes):
    """Reorder ``img_axes`` of ``a`` from the sigma basis back to natural
    order (the inverse of :func:`to_sigma_basis`)."""
    from ..utils import as_tensor

    a = as_tensor(a)
    for ax in img_axes:
        idx = torch.from_numpy(np.argsort(_sigma_order(a.shape[ax])))
        a = a.index_select(ax, idx.to(a.device))
    return a


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


def fft_factors(n: int):
    """(p, q) with n = p q: the two factors of the kernels' n-point FFT.
    p = 16 when 16 divides n, else 8 (radix-2 in registers); q = n / p
    <= 32 (radix-2 in registers for 8 and 16, direct sums otherwise).
    K1/K2 take n <= 256 (:func:`supported`); the adjoint pad-DFT
    (``ops.pad_dft_cuda``) takes every n this plans."""
    p = 16 if n % 16 == 0 else 8
    if n % 8 or n < 8 or n // p > 32:
        raise ValueError(f"no FFT plan for an axis of {n}")
    return p, n // p


def fft_table(n: int) -> np.ndarray:
    """The axis's twiddle table as the kernels receive it: W_2n^k =
    exp(-i pi k / n) for k < 2n, computed in float64, rounded to complex64.
    It holds the doubling twiddle t (k < n), W_n^m (k = 2m) and the small
    factors' W_p^m (k = 2qm) and W_q^m (k = 2pm)."""
    return np.exp(-1j * np.pi * np.arange(2 * n) / n).astype(np.complex64)


def fft_positions(n: int) -> np.ndarray:
    """Row of frequency k after the kernels' forward transform:
    q (k mod p) + k div p (frequency k1 + p k2 lands at row q k1 + k2)."""
    p, q = fft_factors(n)
    k = np.arange(n)
    return q * (k % p) + k // p


def _factor_mats(n, inverse=False, exact=False):
    """(w, Fp, Fq, tw) of an n-point axis in complex128: the table W_2n^k
    (the kernels' f32 :func:`fft_table`, or float64 when ``exact``),
    W_p^{jk}, W_q^{jk} and W_n^{ab}; conjugated for the inverse."""
    p, q = fft_factors(n)
    if exact:
        w = torch.from_numpy(np.exp(-1j * np.pi * np.arange(2 * n) / n))
    else:
        w = torch.from_numpy(fft_table(n)).to(torch.complex128)
    if inverse:
        w = w.conj()
    ip, iq = torch.arange(p), torch.arange(q)
    Fp = w[(ip[:, None] * ip[None, :]) % p * (2 * q)]      # W_p^{jk}
    Fq = w[(iq[:, None] * iq[None, :]) % q * (2 * p)]      # W_q^{jk}
    tw = w[2 * ip[:, None] * iq[None, :]]                  # W_n^{ab}
    return w, Fp, Fq, tw


def four_step(x, inverse=False, exact=False):
    """The kernels' n-point transform along the last axis, with their
    factors and f32 table (float64 twiddles when ``exact``), in their index
    order (complex128 arithmetic).

    Forward: natural order in, :func:`fft_positions` order out. Inverse
    (unnormalised, conjugate table): that order in, natural order out.
    Forward: p-point DFTs along the stride-q runs, times W_n^{ab}, then
    q-point DFTs along the contiguous runs; the inverse runs the same
    steps in the other order."""
    n = int(x.shape[-1])
    p, q = fft_factors(n)
    _, Fp, Fq, tw = _factor_mats(n, inverse, exact)
    X = x.to(torch.complex128).reshape(x.shape[:-1] + (p, q))
    if not inverse:
        Y = torch.einsum("...jb,jk->...kb", X, Fp) * tw    # row q k1 + b
        Z = torch.einsum("...aj,jk->...ak", Y, Fq)         # row q k1 + k2
    else:
        Y = torch.einsum("...aj,jk->...ak", X, Fq) * tw    # row q a + m1
        Z = torch.einsum("...am,ak->...km", Y, Fp)         # row q m2 + m1
    return Z.reshape(x.shape)


def _round_trip(x, T, exact=False):
    """The zero-aware doubled round trip along the last axis, as the
    kernels run it: x (..., n), T (..., 2n) real in block layout ->
    (IF(T_even F x) + conj(t) IF(T_odd F(t x))) / 2n, through
    :func:`four_step` in its index order."""
    n = int(x.shape[-1])
    w, _, _, _ = _factor_mats(n, exact=exact)
    t = w[:n]
    pos = torch.from_numpy(fft_positions(n))
    out = 0
    for h in (0, 1):
        X = four_step(x * t if h else x, exact=exact)
        Y = torch.empty_like(X)
        Y[..., pos] = X[..., pos] * T[..., h * n:(h + 1) * n]
        y = four_step(Y, inverse=True, exact=exact)
        out = out + (y * t.conj() if h else y)
    return out * (0.5 / n)


def plane_pass(t1, Tf, exact=False):
    """The plane pass (``kern_x`` of ``csrc/sense_normal.cu``) in torch,
    complex128, in the kernel's index orders. t1 (B, 2n1, n2, n3): the
    volumes after the z forward; Tf (2n1, 2n2, 2n3) real in block layout.
    Returns each plane's y forward, x round trip with its spectrum rows and
    y inverse with crop, which the kernel writes back over t1.

    Per y-half h (the odd one times t): the p-point stage along the
    stride-q runs b (row q j + b), times W_n^{ab}, gives line (h, a, b);
    the q-point stage over b gives line (h, a, k), y-frequency a + p k; the
    line takes the x round trip with spectrum row h n2 + a + p k; the
    inverse q-point stage over k, times W_n^{-ab}, and the inverse p-point
    stage over a give row b + q m; the halves add up as
    (e + conj(t) o) / 2 n2. The kernel runs both y stages of a 16-column
    bundle in one block and the x round trip on 16 lines at a time; the
    sums are these. ``exact``: float64 twiddles instead of the kernels' f32
    tables."""
    B, Z, n2, n3 = (int(s) for s in t1.shape)
    p, q = fft_factors(n2)
    w, Fp, Fq, tw = _factor_mats(n2, exact=exact)
    _, iFp, iFq, itw = _factor_mats(n2, True, exact)
    t = w[:n2].reshape(p, q, 1)
    x = t1.to(torch.complex128).reshape(B, Z, p, q, n3)    # row q j + b
    # spectrum row h n2 + a + p k of line (h, a, k)
    T = Tf.to(torch.float64).reshape(Z, 2, q, p, 2 * n3).transpose(2, 3)
    out = 0
    for h in (0, 1):
        xh = x * t if h else x
        Y = torch.einsum("...jbx,ja->...abx", xh, Fp) * tw[..., None]
        L = torch.einsum("...abx,bk->...akx", Y, Fq)       # line (h, a, k)
        L = _round_trip(L, T[:, h], exact)
        U = torch.einsum("...akx,km->...amx", L, iFq) * itw[..., None]
        V = torch.einsum("...amx,an->...nmx", U, iFp)       # row q n + m
        out = out + (V * t.conj() if h else V)
    return (out * (0.5 / n2)).reshape(B, Z, n2, n3)


@lru_cache(maxsize=16)
def _fft_tables(n1, n2, n3, device):
    """One device table of the three axes' twiddles, and each axis's
    (offset, p)."""
    tabs = [fft_table(n) for n in (n1, n2, n3)]
    offs = np.cumsum([0] + [len(t) for t in tabs[:-1]])
    tab = torch.from_numpy(np.concatenate(tabs)).to(device)
    return tab, [(int(o), fft_factors(n)[0]) for o, n in zip(offs,
                                                              (n1, n2, n3))]


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
    if Tf.data_ptr() % 16:
        raise ValueError(f"{name}: Tf must start on a 16-byte boundary "
                         "(the x pass copies it with 16-byte cp.async)")


def _run(Tf, v, maps, events):
    """Allocate t1, the plane pass's ring and task counts, and the output,
    then enqueue the three passes (z forward, the plane pass, z inverse) on
    the current stream: K1's instances with ``maps``, K2's without. Each
    launch adds one to its wrapper's ``launches``, the plane pass one to its
    ``plane_calls``."""
    from ._build import load_library

    lib = load_library()
    fn = toeplitz_apply_cuda if maps is None else sense_normal_cuda
    S, n1, n2, n3 = (int(s) for s in v.shape)
    cc = 1 if maps is None else int(maps.shape[0])
    B = S * cc
    dev = v.device
    tab, axes = _fft_tables(n1, n2, n3, dev)
    (tz, pz), (ty, py), (tx, px) = ((tab.data_ptr() + 8 * o, p)
                                    for o, p in axes)
    t1 = torch.empty((B, 2 * n1, n2, n3), dtype=torch.complex64, device=dev)
    # the plane pass's ring of y-spectra and its per-plane task counts
    ring = torch.empty((lib.indigo_toeplitz_ring_planes(), 2 * n2, n3),
                       dtype=torch.complex64, device=dev)
    cnt = torch.empty(3 * 2 * n1 * B + 1, dtype=torch.int32, device=dev)
    out = torch.empty_like(v)
    p1, pv, po = t1.data_ptr(), v.data_ptr(), out.data_ptr()
    pm = None if maps is None else maps.data_ptr()

    # the launchers size their grids for, and launch on, the current device
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream().cuda_stream
        if events is not None:
            events[0].record()
        launches = (
            ("z forward", lambda: lib.indigo_toeplitz_fz(
                pv, pm, tz, pz, p1, S, cc, n1, n2, n3, st)),
            ("plane", lambda: lib.indigo_toeplitz_plane(
                p1, Tf.data_ptr(), ty, py, tx, px, ring.data_ptr(),
                cnt.data_ptr(), B, n1, n2, n3, st)),
            ("z inverse", lambda: lib.indigo_toeplitz_iz(
                p1, pm, tz, pz, po, S, cc, n1, n2, n3, st)))
        for i, (what, launch) in enumerate(launches, 1):
            _check(lib, launch(), f"{fn.__name__} {what} pass")
            fn.launches += 1
            if what == "plane":
                fn.plane_calls += 1
            if events is not None:
                events[i].record()
    return out


class _SenseNormalFn(torch.autograd.Function):
    """out = N v, differentiable in v, for the Hermitian N of K1 (``maps``
    given) or K2 (``maps`` None). ``launch(Tf, v, maps, events)`` computes
    N v: :func:`_run` on the card, a plain version in the CPU tests. The
    backward is N^H g = N g, one more launch on the cotangent, in a span
    with attr ``backward=True`` (``indigo.normal_op`` for K1,
    ``indigo.toeplitz`` for K2) and counted in the wrapper's
    ``backward_calls``; ``events`` time the forward only."""

    @staticmethod
    def forward(ctx, launch, Tf, maps, v, events=None):
        ctx.launch = launch
        ctx.save_for_backward(Tf, maps)
        return launch(Tf, v, maps, events)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        Tf, maps = ctx.saved_tensors
        k1 = maps is not None
        (sense_normal_cuda if k1 else toeplitz_apply_cuda).backward_calls += 1
        with tracing.span("indigo.normal_op" if k1 else "indigo.toeplitz",
                          backward=True):
            gv = ctx.launch(Tf, g.contiguous(), maps, None)
        return None, None, None, gv, None


def sense_normal_cuda(Tf, maps, v, events=None):
    """Launch the CUDA Toeplitz SENSE normal op K1 (three kernels).

    Tf: (2n1, 2n2, 2n3) float32 (:func:`kernel_spectrum` layout); maps
    (nc, n1, n2, n3) and v (S, n1, n2, n3) complex64, contiguous, on one
    CUDA device. Returns (S, n1, n2, n3) complex64. CPU tensors run the
    plain version; anything else the kernels do not take raises. With grad
    mode on and ``v.requires_grad`` the result carries the graph, and its
    backward launches K1 on the cotangent; ``Tf`` or ``maps`` that require
    grad raise.
    ``events``: optional ``LAUNCHES_PER_CALL + 1`` ``torch.cuda.Event``s
    recorded before the first kernel and after each, for per-kernel timing.
    Counts: ``launches`` (kernels), ``plane_calls`` (calls that ran the
    plane pass, every call the kernels take, the backward's too),
    ``backward_calls`` (backward launches on a cotangent).
    """
    if v.device.type == "cpu":
        return sense_normal_reference(Tf, maps, v)
    _validate("sense_normal_cuda", Tf, v, maps)
    _refuse_operator_grad("sense_normal_cuda", Tf=Tf, maps=maps)
    return _SenseNormalFn.apply(_run, Tf, maps, v, events)


sense_normal_cuda.launches = 0
sense_normal_cuda.plane_calls = 0
sense_normal_cuda.backward_calls = 0


def toeplitz_apply_cuda(Tf, u, events=None):
    """Launch the CUDA Toeplitz round trip K2 (three kernels): the
    counterpart of ``toeplitz_apply_pallas``.

    Tf: (2n1, 2n2, 2n3) float32 (:func:`kernel_spectrum` layout); u
    (B, n1, n2, n3) complex64, contiguous, on Tf's CUDA device. Returns
    (B, n1, n2, n3) complex64. CPU tensors run the plain version; anything
    else the kernels do not take raises (a non-contiguous u is never copied
    here). Gradients in u: as for :func:`sense_normal_cuda`, with K2.
    ``events``, ``launches``, ``plane_calls``, ``backward_calls``: as for
    :func:`sense_normal_cuda`.
    """
    if u.device.type == "cpu":
        return toeplitz_apply_reference(Tf, u)
    _validate("toeplitz_apply_cuda", Tf, u)
    _refuse_operator_grad("toeplitz_apply_cuda", Tf=Tf)
    return _SenseNormalFn.apply(_run, Tf, None, u, events)


toeplitz_apply_cuda.launches = 0
toeplitz_apply_cuda.plane_calls = 0
toeplitz_apply_cuda.backward_calls = 0
