"""Collectives over a mesh axis: ``all_to_all``, ``psum``, ``psum_scatter``
and ``all_gather``, plain functions on a tensor and the mesh.

Counterpart of the ``jax.lax`` calls the reference makes inside
``shard_map`` (``all_to_all(..., tiled=True)``, ``psum``,
``psum_scatter(..., tiled=True)``); ``all_gather`` assembles the global
result that ``shard_map``'s out_specs assemble there. An axis of size 1 is a
no-op that copies nothing.

Every collective goes through one of three transport functions
(``exchange``, ``reduce_sum``, ``gather_blocks``), which hand contiguous real
tensors to ``torch.distributed`` (complex data as its ``view_as_real``). The
backend decides how the payload travels, and nothing else changes with it:

* NCCL (one card per rank): the tensors go as they are, on the current
  stream, with no host synchronisation.
* gloo with CPU tensors: as they are.
* gloo with CUDA tensors (ranks that share one card): gloo moves host
  memory, so the payload is staged through two pinned host buffers, one
  pair per process whatever the number of meshes (``release_staging`` frees
  them). That is a transport between ranks on one card, not a fallback of
  the computation: every other operation stays on the card. It synchronises
  the stream, as any copy to the host does.

``mesh.stats`` accumulates, per rank, the calls, the payload bytes handed to
the transport (for ``all_to_all`` the blocks that leave the rank, for the
others the tensor itself) and, where the transport is synchronous (gloo),
the seconds spent inside it. NCCL queues its work on the stream and returns,
so the host cannot time it: ``stats["seconds"]`` is then None, not 0.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "psum", "psum_scatter", "all_gather", "transport",
           "exchange", "reduce_sum", "gather_blocks", "release_staging"]

# role ("in", "out") -> this process's flat pinned host buffer, grow-only
_STAGING = {}


def transport(mesh, group=None):
    """How this mesh's collectives travel: "nccl", "gloo" or "gloo, staged
    through pinned host memory"."""
    backend = dist.get_backend(group if group is not None else mesh.group())
    if backend == "gloo" and mesh.device.type == "cuda":
        return "gloo, staged through pinned host memory"
    return backend


def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def _like(r, x):
    return torch.view_as_complex(r) if x.is_complex() else r


def _staging(role, shape, dtype):
    """A pinned host tensor of this shape and (real) dtype, a view of the
    process's grow-only flat buffer for ``role``."""
    need = math.prod(shape) * dtype.itemsize
    buf = _STAGING.get(role)
    if buf is None or buf.numel() < need:
        _STAGING.pop(role, None)
        buf = torch.empty(need, dtype=torch.uint8, pin_memory=True)
        _STAGING[role] = buf
    return buf[:need].view(dtype).view(tuple(shape))


def release_staging():
    """Free the pinned staging buffers (they come back on demand)."""
    _STAGING.clear()


def _run(mesh, group, x, sent_bytes, call):
    """``call(src, staged)`` on the real view of the contiguous tensor
    ``x``, or on its pinned host copy for a CUDA tensor on a gloo group
    (``staged``: the result then comes back to the card); keep the mesh's
    counters."""
    xr = _real(x)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    sync = staged or not x.is_cuda
    if staged:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    if staged:
        src = _staging("in", xr.shape, xr.dtype)
        src.copy_(xr)
        out = call(src, True).to(x.device)
    else:
        out = call(xr, False)
    if not sync:
        mesh.stats["seconds"] = None
    elif mesh.stats["seconds"] is not None:
        mesh.stats["seconds"] += time.perf_counter() - t0
    mesh.stats["bytes_sent"] += int(sent_bytes)
    mesh.stats["calls"] += 1
    return out


def exchange(send, mesh, group):
    """One ``all_to_all_single``: ``send`` (p, *block) contiguous, block j
    goes to rank j of ``group``; returns (p, *block) with block i received
    from rank i."""
    p = dist.get_world_size(group)
    if send.shape[0] != p or not send.is_contiguous():
        raise ValueError(f"exchange needs a contiguous (p={p}, ...) tensor, "
                         f"got {tuple(send.shape)}")
    nbytes = send.numel() * send.element_size()

    def call(src, staged):
        dst = (_staging("out", src.shape, src.dtype) if staged
               else torch.empty_like(src))
        dist.all_to_all_single(dst, src, group=group)
        return dst

    return _like(_run(mesh, group, send, nbytes * (p - 1) // p, call), send)


def reduce_sum(x, mesh, group):
    """Sum of ``x`` over the ranks of ``group``, the same bits on every rank
    (one ``all_reduce``). Returns a new tensor."""
    def call(src, staged):
        dst = src if staged else src.clone()
        dist.all_reduce(dst, op=dist.ReduceOp.SUM, group=group)
        return dst

    x = x.contiguous()
    return _like(_run(mesh, group, x, x.numel() * x.element_size(), call), x)


def gather_blocks(x, mesh, group):
    """(p, *x.shape): the tensors of all ranks of ``group`` in rank order
    (one ``all_gather``)."""
    p = dist.get_world_size(group)

    def call(src, staged):
        shape = (p,) + tuple(src.shape)
        dst = (_staging("out", shape, src.dtype) if staged
               else src.new_empty(shape))
        dist.all_gather(list(dst.unbind(0)), src, group=group)
        return dst

    x = x.contiguous()
    return _like(_run(mesh, group, x, x.numel() * x.element_size(), call), x)


def _axis(mesh, axis):
    mesh.require_member()
    return mesh.shape[axis], mesh.group(axis)


def all_to_all(x, mesh, axis, split_axis, concat_axis):
    """Split ``x`` into p blocks along ``split_axis``, send block j to rank
    j of the mesh axis, and concatenate the received blocks along
    ``concat_axis`` in rank order (``jax.lax.all_to_all(..., tiled=True)``).
    Makes its blocks contiguous itself; complex64 travels as it is."""
    p, group = _axis(mesh, axis)
    if p == 1:
        return x
    n = x.shape[split_axis]
    if n % p:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"is not divisible by the mesh axis {axis}={p}")
    shape = list(x.shape)
    shape[split_axis:split_axis + 1] = [p, n // p]
    send = x.reshape(shape).movedim(split_axis, 0).contiguous()
    recv = exchange(send, mesh, group)            # (p, *block), by source
    out = recv.movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [p * shape[concat_axis + 1]]
    return out.reshape(shape)


def psum(x, mesh, axes):
    """Sum of ``x`` over one mesh axis or a tuple of them, one ``all_reduce``
    per axis in the order given; every rank of those axes gets the same
    bits (``jax.lax.psum``)."""
    mesh.require_member()
    if isinstance(axes, str):
        axes = (axes,)
    for a in axes:
        if mesh.shape[a] > 1:
            x = reduce_sum(x, mesh, mesh.group(a))
    return x


def psum_scatter(x, mesh, axis, scatter_dimension):
    """Sum ``x`` over the mesh axis and leave rank j the j-th of p blocks
    along ``scatter_dimension`` (``jax.lax.psum_scatter(..., tiled=True)``).

    One ``all_to_all`` of the blocks, then a sum in rank order: it needs no
    ``reduce_scatter`` of the backend and its summation order is fixed."""
    p, group = _axis(mesh, axis)
    if p == 1:
        return x
    n = x.shape[scatter_dimension]
    if n % p:
        raise ValueError(
            f"psum_scatter: dim {scatter_dimension} of {tuple(x.shape)} is "
            f"not divisible by the mesh axis {axis}={p}")
    shape = list(x.shape)
    shape[scatter_dimension:scatter_dimension + 1] = [p, n // p]
    send = x.reshape(shape).movedim(scatter_dimension, 0).contiguous()
    recv = exchange(send, mesh, group)
    out = recv[0].clone()
    for i in range(1, p):
        out += recv[i]
    return out


def all_gather(x, mesh, axis, dim):
    """Concatenate the blocks of all ranks of the mesh axis along ``dim``,
    in rank order; every rank gets the whole."""
    p, group = _axis(mesh, axis)
    if p == 1:
        return x
    out = gather_blocks(x, mesh, group).movedim(0, dim)
    shape = list(out.shape)
    shape[dim:dim + 2] = [p * shape[dim + 1]]
    return out.reshape(shape)
