"""Batched SENSE normal operator and per-slice CG (torch).

Counterpart of ``indigo_tpu/parallel/recon.py`` (``sense_normal_batched``,
``batched_cg``). The sharded and volume-sharded solvers are still to be
ported (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import math

import torch

__all__ = ["sense_normal_batched", "batched_cg"]


def sense_normal_batched(Tf, maps, xs, coil_chunk=None, layout="block"):
    """Batched Toeplitz SENSE normal op.

    Tf:   (*2N) float32 — spectrum, block layout (``block_spectrum``, which
          is also the CUDA kernel's ``kernel_spectrum`` layout)
    maps: (nc, *N) complex64 coil maps
    xs:   (S, n) complex64 — S flattened slice images
    returns (S, n).

    ``layout``: "block" runs the plain torch matmul-DFT pipeline (any rank,
    any device); "kernel" runs the CUDA kernel (3D, on the GPU; CPU tensors
    take its plain version). ``coil_chunk`` processes the coils in chunks of
    this size (snapped to a divisor of nc), bounding the doubled-grid working
    set; the chunks are a Python loop of one normal-op call each.
    """
    from ..ops.dft_cuda import sense_normal_cuda, sense_normal_reference

    img_shape = tuple(maps.shape[1:])
    nc = maps.shape[0]
    S = xs.shape[0]
    v = xs.reshape((S,) + img_shape)

    if layout == "kernel":
        v = v.to(torch.complex64).contiguous()

        def chunk_contrib(m):
            return sense_normal_cuda(Tf, m, v)
    elif layout == "block":
        def chunk_contrib(m):
            return sense_normal_reference(Tf, m, v)
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
