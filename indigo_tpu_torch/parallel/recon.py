"""Batched SENSE normal operator, per-slice CG, and the batch, slab and
pencil solvers on one device or over a mesh (torch).

Counterpart of ``indigo_tpu/parallel/recon.py``:

* ``sense_normal_batched``, ``batched_cg``: the normal op over a (slice,
  coil, *image) batch and the per-slice CG, on the tensors they are given;
* ``sense_batch_recon``: many slices on one device or, with ``mesh`` (axes
  'slice' and 'coil'), slices over 'slice' and coils over 'coil', the coil
  sum a ``psum``;
* ``sense_normal_volsharded`` / ``sense_vol_recon``: one 3D volume in z
  slabs over one mesh axis; ``sense_normal_volsharded2`` /
  ``sense_vol_recon2``: in (z, y) pencils over two.

Where the reference wraps a block function in ``shard_map``, every rank of
the mesh here calls the entry point with the same global arrays, cuts its
own block (``mesh.Placement``), runs the whole CG on it and gets the global
result back; the collectives are ``parallel.collectives``.
"""
from __future__ import annotations

import math

import torch

from .. import tracing
from ..solvers import _cg_steps, _rowdot, _shift
from ..utils import as_tensor, common_device
from .collectives import all_to_all, psum
from .mesh import Placement

__all__ = [
    "sense_normal_batched", "batched_cg", "sense_batch_recon",
    "sense_normal_volsharded", "sense_vol_recon",
    "sense_normal_volsharded2", "sense_vol_recon2",
]


def _block_layout(Tf):
    """Raw doubled-grid spectrum tensor -> block (even|odd) layout on every
    axis (``ops.dft_fft.block_perm``), on its own device."""
    from ..ops.dft_fft import block_perm

    for ax, s in enumerate(Tf.shape):
        idx = torch.from_numpy(block_perm(int(s))).to(Tf.device)
        Tf = Tf.index_select(ax, idx)
    return Tf


def sense_normal_batched(Tf, maps, xs, coil_chunk=None, layout="raw",
                         sigma=False, device=None):
    """Batched Toeplitz SENSE normal op.

    Tf:   (*2N) float32 spectrum, stored as ``layout`` says
    maps: (nc, *N) complex64 coil maps
    xs:   (S, n) complex64 — S flattened slice images
    returns (S, n).

    Tensors or host data: host data is narrowed and goes to ``device``, by
    default the device of the tensors given, else the card
    (``utils.common_device``: an error where there is none). Tensors move
    only to a ``device`` given; on two devices without one they raise.

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
    Python loop of one normal-op call each.

    ``sigma`` (layout "kernel"/"pallas", as in the reference): xs' image
    axes longer than 128 are in the sigma basis (``ops.dft_cuda.
    to_sigma_basis``) and the result is returned in it. The reference's
    kernels work in that basis; K1 works in natural order, so xs is
    reordered to natural order, K1 runs, and the result is reordered back.
    """
    with tracing.span("indigo.normal_op"):
        if layout == "pallas":
            layout = "kernel"
        if sigma and layout != "kernel":
            raise ValueError("the sigma basis is a kernel-layout contract "
                             f"(layout 'kernel' or 'pallas'), got {layout!r}")
        from ..ops.dft_cuda import (from_sigma_basis, sense_normal_cuda,
                                    sense_normal_reference, solver_sigma_axes,
                                    to_sigma_basis)
        from ..ops.toeplitz_fft import fft_pad2x, ifft_crop2x

        dev = common_device(Tf, maps, xs, device=device)
        Tf, maps, xs = (as_tensor(a, dev) for a in (Tf, maps, xs))
        img_shape = tuple(maps.shape[1:])
        nc = maps.shape[0]
        S = xs.shape[0]
        v = xs.reshape((S,) + img_shape)
        sig = solver_sigma_axes(img_shape) if sigma else ()
        v = from_sigma_basis(v, sig)

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
        return to_sigma_basis(out, sig).reshape(S, -1).to(xs.dtype)


def batched_cg(matvec, rhs, lamda=0.0, iters=20, psum_axis=None, tol=0.0,
               precond=None, return_iters=False, mesh=None):
    """Per-slice CG with (leading-axis) inner products, optional tol stop
    and preconditioning.

    rhs (S, n): solves (M + lamda I) x_s = rhs_s for every slice jointly.
    Returns (xs, resids) with resids (iters, S) float32; with
    ``return_iters=True`` also the per-slice iteration counts (S,) int32.

    ``tol`` > 0 freezes a slice once its relative residual drops below tol
    (its state stops changing; the loop still runs ``iters`` steps and the
    count reports the steps actually taken). The loop, ``solvers.cg``'s
    too, makes no host sync: every decision is a ``torch.where``.

    ``precond``: callable z = M^{-1}(r), positive definite. ``psum_axis``:
    when the feature dimension itself is sharded over ``mesh`` (volume
    slabs or pencils), the inner products reduce across its ranks: an axis
    name of ``mesh`` or a tuple of names. Every rank then holds the same
    bits in every scalar, so the ``done`` mask, and with it the sequence of
    collectives, is the same on all of them.
    """
    if psum_axis is not None and mesh is None:
        raise ValueError("batched_cg: psum_axis names axes of a mesh; pass "
                         "mesh= along with it")

    def dot(a, b):
        d = _rowdot(a, b)
        return d if psum_axis is None else psum(d, mesh, psum_axis)

    x, k, norms = _cg_steps(_shift(matvec, lamda), torch.zeros_like(rhs),
                            rhs, iters, tol=tol if tol > 0 else None,
                            precond=precond, dot=dot)
    if return_iters:
        return x, norms[1:], k
    return x, norms[1:]


def sense_batch_recon(Tf, maps, rhs, mesh=None, lamda=0.0, iters=20,
                      coil_chunk=None, device=None):
    """Many-slice SENSE recon: CG on the batched normal op, on one device
    or sharded over a mesh.

    Tf (*2N) float32 raw spectrum (what ``toeplitz_kernel`` returns), maps
    (nc, *N) complex64, rhs (S, n) complex64: tensors or numpy arrays. The
    spectrum is permuted into block order once, before the loop; the
    normal op runs K1 (``layout="kernel"``) where
    ``ops.dft_cuda.kernel_serves`` (CUDA tensors, a volume the kernel
    takes), otherwise the plain pipeline (``"block"``). Returns (xs (S, n),
    resids (iters, S)) tensors.

    ``mesh=None``: everything on ``device``, by default the device of the
    tensors given, else the card (``utils.common_device``: an error where
    there is none, and tensors on two devices raise rather than move).
    ``mesh`` (axes 'slice' and 'coil'; every rank calls with the same global
    arrays): maps are cut over 'coil', rhs over 'slice', the spectrum is
    replicated; each rank runs the whole CG on its (slice, coil) block on
    ``mesh.device``, and the only collective in the loop is the ``psum`` of
    the coil combine over 'coil'. ``coil_chunk`` is snapped to a divisor of
    the rank's own coil count. Every rank gets the global result.
    """
    from ..ops.dft_cuda import kernel_serves

    if mesh is None:
        dev = common_device(Tf, maps, rhs, device=device)
        maps = as_tensor(maps, dev, torch.complex64)
        rhs = as_tensor(rhs, dev, torch.complex64)
    else:
        dev = mesh.device
        maps = Placement(mesh, ("coil",)).local(maps, torch.complex64)
        rhs = Placement(mesh, ("slice",)).local(rhs, torch.complex64)
    Tb = _block_layout(as_tensor(Tf, dev, torch.float32)).contiguous()
    img_shape = tuple(maps.shape[1:])
    layout = "kernel" if kernel_serves(img_shape, dev) else "block"

    def mv(v):
        out = sense_normal_batched(Tb, maps, v, coil_chunk=coil_chunk,
                                   layout=layout)
        return out if mesh is None else psum(out, mesh, "coil")

    xs, resids = batched_cg(mv, rhs, lamda=lamda, iters=iters)
    if mesh is None:
        return xs, resids
    return (Placement(mesh, ("slice",)).gather(xs),
            Placement(mesh, (None, "slice")).gather(resids))


def _coil_combine(per_coil, maps_l, v_l):
    """sum_c conj(m_c) * per_coil(m_c * v): all local coils ride one leading
    batch dimension, so each stage sends one message for all of them (the
    reference scans the coils one at a time; the arithmetic is the same)."""
    return torch.sum(maps_l.conj() * per_coil(maps_l * v_l), dim=0)


def sense_normal_volsharded(Tf_l, maps_l, v_l, axis_name="vol", *, mesh):
    """Toeplitz SENSE normal op for ONE volume sharded over its z axis.

    Called by every rank of ``mesh`` with its own blocks (3D volumes, p =
    the mesh axis size):
      Tf_l   (2Nz, 2Ny/p, 2Nx)  <- Placement (None, axis, None)
      maps_l (nc, Nz/p, Ny, Nx) <- Placement (None, axis, None, None)
      v_l    (Nz/p, Ny, Nx)     <- Placement (axis, None, None)

    Per coil: multiply the map; zero-aware padded FFT over the LOCAL axes
    (y, x); all_to_all so z becomes local (splitting the now-doubled y
    axis); padded FFT over z; multiply the matching Tf block; the inverse
    transforms mirrored. Two all_to_all transposes per direction. The
    transforms are ``torch.fft`` (``ops/toeplitz_fft.py``), as the
    reference's are ``jnp.fft`` outside any kernel.
    """
    from ..ops.toeplitz_fft import fft_pad2x, ifft_crop2x

    def per_coil(u):                                  # (nc, Nz/p, Ny, Nx)
        u = fft_pad2x(u, (2, 3))                      # (nc, Nz/p, 2Ny, 2Nx)
        u = all_to_all(u, mesh, axis_name, split_axis=2, concat_axis=1)
        u = fft_pad2x(u, (1,))                        # (nc, 2Nz, 2Ny/p, 2Nx)
        u = Tf_l * u
        u = ifft_crop2x(u, (1,))                      # (nc, Nz, 2Ny/p, 2Nx)
        u = all_to_all(u, mesh, axis_name, split_axis=1, concat_axis=2)
        return ifft_crop2x(u, (2, 3))                 # (nc, Nz/p, Ny, Nx)

    return _coil_combine(per_coil, maps_l, v_l)


def sense_normal_volsharded2(Tf_l, maps_l, v_l, axes=("vz", "vy"), *, mesh):
    """Toeplitz SENSE normal op for ONE volume PENCIL-sharded over two mesh
    axes (a, b) = ``axes`` of sizes (p, q): scales a single volume past the
    slab form's p <= Nz.

    Called by every rank of ``mesh`` with its own blocks:
      Tf_l   (2Nz, 2Ny/p, 2Nx/q)   <- Placement (None, a, b)
      maps_l (nc, Nz/p, Ny/q, Nx)  <- Placement (None, a, b, None)
      v_l    (Nz/p, Ny/q, Nx)      <- Placement (a, b, None)

    Per coil: multiply the map; padded FFT over the LOCAL x axis;
    all_to_all over ``b`` (2Nx splits, y gathers); padded FFT over y;
    all_to_all over ``a`` (2Ny splits, z gathers); padded FFT over z;
    multiply the Tf pencil; the inverse mirrored. Four all_to_alls per
    direction.
    """
    from ..ops.toeplitz_fft import fft_pad2x, ifft_crop2x

    a, b = axes

    def per_coil(u):                                  # (nc, Nz/p, Ny/q, Nx)
        u = fft_pad2x(u, (3,))                        # (.., Ny/q, 2Nx)
        u = all_to_all(u, mesh, b, split_axis=3, concat_axis=2)
        u = fft_pad2x(u, (2,))                        # (nc, Nz/p, 2Ny, 2Nx/q)
        u = all_to_all(u, mesh, a, split_axis=2, concat_axis=1)
        u = fft_pad2x(u, (1,))                        # (nc, 2Nz, 2Ny/p, 2Nx/q)
        u = Tf_l * u
        u = ifft_crop2x(u, (1,))                      # (nc, Nz, 2Ny/p, 2Nx/q)
        u = all_to_all(u, mesh, a, split_axis=1, concat_axis=2)
        u = ifft_crop2x(u, (2,))                      # (nc, Nz/p, Ny, 2Nx/q)
        u = all_to_all(u, mesh, b, split_axis=2, concat_axis=3)
        return ifft_crop2x(u, (3,))                   # (nc, Nz/p, Ny/q, Nx)

    return _coil_combine(per_coil, maps_l, v_l)


def _vol_solve(normal, Tf, maps, rhs, mesh, spec, psum_axis, lamda, iters):
    """CG for one volume cut by ``spec`` (the mesh axes on its leading
    dims): blocks of Tf (one dim later, on the doubled grid), maps and rhs,
    the whole CG per rank, the global image back on every rank."""
    Tf_l = Placement(mesh, (None,) + spec).local(Tf, torch.float32)
    maps_l = Placement(mesh, (None,) + spec).local(maps, torch.complex64)
    vol = Placement(mesh, spec)
    rhs_l = vol.local(rhs, torch.complex64)

    def mv(v):
        return normal(Tf_l, maps_l, v.reshape(rhs_l.shape)).reshape(1, -1)

    xs, resids = batched_cg(mv, rhs_l.reshape(1, -1), lamda=lamda,
                            iters=iters, psum_axis=psum_axis, mesh=mesh)
    return vol.gather(xs.reshape(rhs_l.shape)), resids[:, 0]


def sense_vol_recon2(Tf, maps, rhs, mesh, axes=("vz", "vy"), lamda=0.0,
                     iters=20):
    """CG-SENSE for ONE 3D volume pencil-sharded over TWO mesh axes.

    Same contract as :func:`sense_vol_recon`, with the volume cut (z over
    ``axes[0]`` size p, y over ``axes[1]`` size q). Inner products reduce
    over both axes. Requires Nz % p == 2Ny % p == Ny % q == 2Nx % q == 0.
    """
    img_shape = tuple(maps.shape[1:])
    if len(img_shape) != 3:
        raise ValueError("sense_vol_recon2 supports 3D volumes")
    a, b = axes
    p, q = mesh.shape[a], mesh.shape[b]
    Nz, Ny, Nx = img_shape
    if Nz % p or (2 * Ny) % p or Ny % q or (2 * Nx) % q:
        raise ValueError(
            f"volume {img_shape} not compatible with mesh axes {a}={p}, "
            f"{b}={q}: need Nz%p == 2Ny%p == Ny%q == 2Nx%q == 0")

    def normal(Tf_l, maps_l, v_l):
        return sense_normal_volsharded2(Tf_l, maps_l, v_l, (a, b),
                                        mesh=mesh)

    return _vol_solve(normal, Tf, maps, rhs, mesh, (a, b), (a, b), lamda,
                      iters)


def sense_vol_recon(Tf, maps, rhs, mesh, axis_name="vol", lamda=0.0,
                    iters=20):
    """CG-SENSE for ONE 3D volume sharded over ``axis_name`` of ``mesh``.

    Tf (*2N) float32 raw spectrum, maps (nc, *N), rhs (*N) complex: tensors
    or numpy arrays, the same global arrays on every rank. The whole CG
    runs per rank on its z slab; inner products reduce over the axis.
    Returns (x (*N), resids (iters,)) tensors on the mesh's device, on
    every rank.
    """
    img_shape = tuple(maps.shape[1:])
    if len(img_shape) != 3:
        raise ValueError(
            f"sense_vol_recon supports 3D volumes, got {img_shape}; use "
            "sense_batch_recon for 2D problems")
    p = mesh.shape[axis_name]
    if img_shape[0] % p or (2 * img_shape[1]) % p:
        raise ValueError(
            f"z ({img_shape[0]}) must be divisible by the mesh axis size "
            f"{p}, and 2*Ny ({2 * img_shape[1]}) by {p} for the all_to_all "
            "transpose")

    def normal(Tf_l, maps_l, v_l):
        return sense_normal_volsharded(Tf_l, maps_l, v_l, axis_name,
                                       mesh=mesh)

    return _vol_solve(normal, Tf, maps, rhs, mesh, (axis_name,), axis_name,
                      lamda, iters)
