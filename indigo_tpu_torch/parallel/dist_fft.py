"""Distributed multi-axis FFT: per-axis ``torch.fft`` transforms and
``all_to_all`` transposes over a mesh.

Counterpart of ``indigo_tpu/parallel/dist_fft.py``, with the same sequence
of local transforms and transposes: (local FFT over the unsharded axes) ->
all_to_all -> (local FFT over the remaining axis) -> all_to_all back. As in
the reference, a call takes the global array and returns the global array:
every rank of the mesh passes the same array (numpy or tensor), works on
its own block, and gets the whole result back (a tensor on the mesh's
device).
"""
from __future__ import annotations

import torch

from .collectives import all_to_all
from .mesh import Placement

__all__ = ["fftn_sharded", "fftn_sharded2"]


def fftn_sharded(v, mesh, axis_name="x", inverse=False):
    """FFT over all axes of ``v`` (>=2D), sharded on dim 0 over the mesh
    axis. v: complex array (X, Y, ...) with X and Y divisible by the mesh
    axis size; returns the same shape."""
    nd = v.ndim
    fft = torch.fft.ifftn if inverse else torch.fft.fftn
    p = mesh.shape[axis_name]
    if v.shape[0] % p or v.shape[1] % p:
        raise ValueError(
            f"dims 0 and 1 of {tuple(v.shape)} must each be divisible by "
            f"the mesh axis size {p}")
    place = Placement(mesh, (axis_name,))
    local = place.local(v, torch.complex64)
    # local: (X/p, Y, ...); FFT all axes except 0
    local = fft(local, dim=tuple(range(1, nd)))
    # reshard: split axis 1 across ranks, gather axis 0
    local = all_to_all(local, mesh, axis_name, split_axis=1, concat_axis=0)
    # now (X, Y/p, ...): FFT the remaining axis
    local = fft(local, dim=(0,))
    # reshard back
    local = all_to_all(local, mesh, axis_name, split_axis=0, concat_axis=1)
    return place.gather(local)


def fftn_sharded2(v, mesh, axes=("x", "y"), inverse=False):
    """FFT over all axes of a >=3D ``v`` pencil-sharded on dims 0 and 1.

    With v (X, Y, Z, ...) sharded (X over ``axes[0]`` size p, Y over
    ``axes[1]`` size q), each rank holds an (X/p, Y/q, Z, ...) pencil and
    every FFT stage is local:

        FFT(z..)  ->  all_to_all[b] (Z->Y)  ->  FFT(y)
                  ->  all_to_all[a] (Y->X)  ->  FFT(x)  -> undo both

    Requires X % p == Y % p == Y % q == Z % q == 0.
    """
    nd = v.ndim
    if nd < 3:
        raise ValueError("fftn_sharded2 needs >= 3 dims (pencil form); "
                         "use fftn_sharded for 2D")
    a, b = axes
    p, q = mesh.shape[a], mesh.shape[b]
    X, Y, Z = v.shape[0], v.shape[1], v.shape[2]
    if X % p or Y % p or Y % q or Z % q:
        raise ValueError(
            f"shape {tuple(v.shape)} not compatible with mesh axes {a}={p}, "
            f"{b}={q}: need X%p == Y%p == Y%q == Z%q == 0")
    fft = torch.fft.ifftn if inverse else torch.fft.fftn
    place = Placement(mesh, (a, b))
    local = place.local(v, torch.complex64)
    # (X/p, Y/q, Z, ...): FFT the fully-local trailing axes
    local = fft(local, dim=tuple(range(2, nd)))
    # gather Y by splitting Z over axis b: (X/p, Y, Z/q, ...)
    local = all_to_all(local, mesh, b, split_axis=2, concat_axis=1)
    local = fft(local, dim=(1,))
    # gather X by splitting Y over axis a: (X, Y/p, Z/q, ...)
    local = all_to_all(local, mesh, a, split_axis=1, concat_axis=0)
    local = fft(local, dim=(0,))
    # undo both reshards
    local = all_to_all(local, mesh, a, split_axis=0, concat_axis=1)
    local = all_to_all(local, mesh, b, split_axis=1, concat_axis=2)
    return place.gather(local)
