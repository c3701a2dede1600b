"""Batched SENSE normal operator, per-slice CG and the batch solver (torch).

Counterpart of ``indigo_tpu/parallel/recon.py`` (``sense_normal_batched``,
``batched_cg``, ``sense_batch_recon`` on one device). The sharded and
volume-sharded solvers are still to be ported (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sense_normal_batched", "batched_cg", "sense_batch_recon"]


def _block_layout(Tf):
    """Raw doubled-grid spectrum tensor -> block (even|odd) layout on every
    axis (``ops.dft_fft.block_perm``), on its own device."""
    from ..ops.dft_fft import block_perm

    for ax, s in enumerate(Tf.shape):
        idx = torch.from_numpy(block_perm(int(s))).to(Tf.device)
        Tf = Tf.index_select(ax, idx)
    return Tf


def sense_normal_batched(Tf, maps, xs, coil_chunk=None, layout="raw",
                         sigma=False):
    """Batched Toeplitz SENSE normal op.

    Tf:   (*2N) float32 spectrum, stored as ``layout`` says
    maps: (nc, *N) complex64 coil maps
    xs:   (S, n) complex64 — S flattened slice images
    returns (S, n).

    ``layout``: how Tf is stored and which pipeline runs.
      "raw" (default, as in the reference): natural frequency order, what
        ``toeplitz_kernel`` returns. It is permuted into block order on
        every call (a (2N)^d gather: 0.54 GB at 256^3), then runs as
        "block". Callers that loop (``SenseRecon``, ``sense_batch_recon``)
        permute once and pass "block" or "kernel" instead — the reference
        relies on XLA to hoist that permute out of its loop.
      "block": block layout (``block_spectrum``, which is also the CUDA
        kernel's ``kernel_spectrum``); the plain torch matmul-DFT pipeline,
        any rank, any device.
      "kernel": block layout; the CUDA kernel K1 (3D, on the GPU; CPU
        tensors take its plain version). "pallas", the reference's name
        for its fused-kernel layout, is accepted as a synonym.
      "fft": raw order; the per-axis ``torch.fft`` path
        (``ops/toeplitz_fft.py``), kept as a cross-check.
    ``coil_chunk`` processes the coils in chunks of this size (snapped to a
    divisor of nc), bounding the doubled-grid working set; the chunks are a
    Python loop of one normal-op call each. ``sigma`` is the reference's
    TPU-only basis switch: False is accepted, True raises (the CUDA kernel
    works in natural order).
    """
    if sigma:
        raise NotImplementedError(
            "sense_normal_batched(sigma=True): the sigma basis is a TPU "
            "kernel contract; the CUDA kernel takes natural-order volumes")
    if layout == "pallas":
        layout = "kernel"
    from ..ops.dft_cuda import sense_normal_cuda, sense_normal_reference
    from ..ops.toeplitz_fft import fft_pad2x, ifft_crop2x

    img_shape = tuple(maps.shape[1:])
    nc = maps.shape[0]
    S = xs.shape[0]
    v = xs.reshape((S,) + img_shape)

    if layout == "raw":
        Tf = _block_layout(Tf)
        layout = "block"
    if layout == "kernel":
        v = v.to(torch.complex64).contiguous()

        def chunk_contrib(m):
            return sense_normal_cuda(Tf, m, v)
    elif layout == "block":
        def chunk_contrib(m):
            return sense_normal_reference(Tf, m, v)
    elif layout == "fft":
        axes = tuple(range(2, 2 + len(img_shape)))

        def chunk_contrib(m):
            U = fft_pad2x(m[None] * v[:, None], axes)
            u = ifft_crop2x(Tf[None, None] * U, axes)
            return torch.sum(m.conj()[None] * u, dim=1)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    if coil_chunk is not None:
        coil_chunk = math.gcd(int(coil_chunk), nc)
    if coil_chunk is None or coil_chunk >= nc:
        out = chunk_contrib(maps)
    else:
        out = None
        for c0 in range(0, nc, coil_chunk):
            part = chunk_contrib(maps[c0:c0 + coil_chunk])
            out = part if out is None else out + part
    return out.reshape(S, -1).to(xs.dtype)


def batched_cg(matvec, rhs, lamda=0.0, iters=20, tol=0.0, precond=None,
               return_iters=False):
    """Per-slice CG with (leading-axis) inner products, optional tol stop
    and preconditioning.

    rhs (S, n): solves (M + lamda I) x_s = rhs_s for every slice jointly.
    Returns (xs, resids) with resids (iters, S) float32; with
    ``return_iters=True`` also the per-slice iteration counts (S,) int32.

    ``tol`` > 0 freezes a slice once its relative residual drops below tol
    (its state stops changing; the loop still runs ``iters`` steps and the
    count reports the steps actually taken). The loop makes no host sync:
    every decision is a ``torch.where`` on the device.

    ``precond``: callable z = M^{-1}(r), positive definite.
    """
    def mv(v):
        out = matvec(v)
        if not (isinstance(lamda, (int, float)) and lamda == 0):
            out = out + lamda * v
        return out

    applyM = precond if precond is not None else (lambda r: r)

    def pdot(a, b):  # per-slice real inner product -> (S, 1)
        return torch.sum((a.conj() * b).real, dim=-1, keepdim=True)

    track = tol > 0
    S = rhs.shape[0]
    x = torch.zeros_like(rhs)
    r = rhs
    p = applyM(r)
    rz = pdot(r, p)
    rs = pdot(r, r)
    bnorm = torch.sqrt(rs)
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    k = torch.zeros((S,), dtype=torch.int32, device=rhs.device)
    done = (torch.sqrt(rs) <= tol * bnorm) if track else None
    resids = []
    for _ in range(iters):
        Ap = mv(p)
        alpha = rz / torch.clamp(pdot(p, Ap), min=1e-30)
        xn = x + alpha.to(x.dtype) * p
        rn = r - alpha.to(r.dtype) * Ap
        z = applyM(rn)
        rzn = pdot(rn, z)
        beta = rzn / torch.clamp(rz, min=1e-30)
        pn = z + beta.to(p.dtype) * p
        rsn = pdot(rn, rn)
        if track:
            keep = done
            x = torch.where(keep, x, xn)
            r = torch.where(keep, r, rn)
            p = torch.where(keep, p, pn)
            rz = torch.where(keep, rz, rzn)
            rs = torch.where(keep, rs, rsn)
            k = torch.where(keep[:, 0], k, k + 1)
            done = done | (torch.sqrt(rsn) <= tol * bnorm)
        else:
            x, r, p, rz, rs = xn, rn, pn, rzn, rsn
            k = k + 1
        resids.append(torch.sqrt(rs[:, 0]))
    resids = (torch.stack(resids) if resids
              else torch.zeros((0, S), device=rhs.device))
    if return_iters:
        return x, resids, k
    return x, resids


def sense_batch_recon(Tf, maps, rhs, mesh=None, lamda=0.0, iters=20,
                      coil_chunk=None):
    """Many-slice SENSE recon on one device: CG on the batched normal op.

    Tf (*2N) float32 raw spectrum (what ``toeplitz_kernel`` returns), maps
    (nc, *N) complex64, rhs (S, n) complex64: tensors or numpy arrays (numpy
    goes to ``maps``' device, the CPU for numpy maps). The spectrum is
    permuted once, before the loop: for CUDA tensors in a volume the kernel
    takes (``ops.dft_cuda.supported``) into ``kernel_spectrum`` order and
    the normal op runs K1 (``layout="kernel"``), otherwise into
    ``block_spectrum`` order on the plain pipeline (``"block"``). Returns
    (xs (S, n), resids (iters, S)) tensors on that device.

    ``mesh``: the sharded solve is not ported yet and raises.
    """
    from ..ops.dft_cuda import supported

    if mesh is not None:
        raise NotImplementedError(
            "sense_batch_recon over a mesh is not ported yet (ROADMAP "
            "Queue 1, item 12); pass mesh=None")
    dev = maps.device if torch.is_tensor(maps) else torch.device("cpu")

    def tensor(a, dtype):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return a.to(device=dev, dtype=dtype)

    maps = tensor(maps, torch.complex64)
    rhs = tensor(rhs, torch.complex64)
    Tb = _block_layout(tensor(Tf, torch.float32)).contiguous()
    img_shape = tuple(maps.shape[1:])
    layout = ("kernel" if dev.type == "cuda" and supported(img_shape)
              else "block")
    return batched_cg(
        lambda v: sense_normal_batched(Tb, maps, v, coil_chunk=coil_chunk,
                                       layout=layout),
        rhs, lamda=lamda, iters=iters)
