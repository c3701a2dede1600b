"""Process meshes over ``torch.distributed``: named axes, their sub-groups
and the placement of arrays on them.

Counterpart of ``indigo_tpu/parallel/mesh.py``. The reference is one
process that sees every device and describes a layout with ``Mesh`` and
``NamedSharding``; here every device is one rank of an initialised process
group, and every rank calls ``make_mesh`` with the same arguments. A
``Mesh`` holds this rank's coordinate on each named axis and one process
sub-group per axis (the ranks that differ only in that coordinate). Ranks
are laid out row-major over the axis sizes, as the reference lays devices
out (``np.asarray(jax.devices()[:total]).reshape(sizes)``), so rank r of a
(4, 2) mesh sits where device r sits there.

A ``Placement`` says which mesh axis lies on which array dimension
(``NamedSharding``'s counterpart). The sharded entry points take the global
array on every rank, cut this rank's block with ``Placement.local`` and
assemble the global result with ``Placement.gather``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "Placement", "make_mesh", "replicated", "shard_along"]


class Mesh:
    """Named axes over the first ``prod(sizes)`` ranks of the default group.

    shape: {axis name: size} in the order given; ranks: the rank ids laid
    out over the axes (numpy, row-major); coords: {axis name: this rank's
    coordinate} (None on a rank outside the mesh); device: where this
    rank's blocks live. ``group(axis)`` is the sub-group along one axis,
    ``group()`` the group of all ranks of the mesh. ``close()`` frees the
    sub-groups; ``make_mesh`` hands out one Mesh per layout, so a caller
    that asks again creates no new groups.
    """

    def __init__(self, names, sizes, device):
        world = dist.get_world_size()
        total = int(np.prod(sizes))
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))
        self.ranks = np.arange(total).reshape(sizes)
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.member = self.rank < total
        self.coords = None
        if self.member:
            self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
                self.rank, self.ranks.shape))))
        # every rank of the default group creates every sub-group, in the
        # same order (torch.distributed requires it), and keeps its own
        self._groups = {}
        self._all = (dist.group.WORLD if total == world
                     else dist.new_group(list(range(total))))
        for d, name in enumerate(names):
            if self.shape[name] == 1:
                continue
            if len(names) == 1:
                self._groups[name] = self._all
                continue
            lines = np.moveaxis(self.ranks, d, -1).reshape(-1, sizes[d])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = g
        self.closed = False
        self._key = None                 # make_mesh's handle on this mesh
        # calls, payload bytes and seconds this rank spent in collectives;
        # seconds turns None once a collective ran on an asynchronous
        # transport (NCCL), where the host cannot time it
        self.stats = {"seconds": 0.0, "bytes_sent": 0, "calls": 0}

    def group(self, axis=None):
        """The process group along ``axis`` (None: the whole mesh). An axis
        of size 1 has no group: its collectives are no-ops."""
        if axis is None:
            return self._all
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {self.shape}")
        return self._groups.get(axis)

    def close(self):
        """Destroy this mesh's sub-groups (never the default group), free
        the pinned staging of the collectives and forget the mesh: the next
        ``make_mesh`` of this layout builds it anew. Every rank of the
        default group calls it, as every rank called ``make_mesh``."""
        from .collectives import release_staging

        if self.closed:
            return
        self.closed = True
        _MESHES.pop(self._key, None)
        groups = set(self._groups.values())
        if self._all is not dist.group.WORLD:
            groups.add(self._all)
        for g in groups:
            if g is not dist.group.WORLD \
                    and g is not dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(g)
        self._groups, self._all = {}, None
        release_staging()

    def require_member(self):
        if self.closed:
            raise RuntimeError(f"the mesh {self.shape} was closed")
        if not self.member:
            raise RuntimeError(
                f"rank {self.rank} lies outside the mesh {self.shape}; only "
                "its ranks call the sharded entry points")

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


# the meshes of the current default group by (names, sizes, device): process
# groups are never collected, so a layout is built once and handed out again
_MESHES = {}
_MESHES_OF = None


def make_mesh(device=None, **axes):
    """Build a Mesh from named axis sizes: ``make_mesh(slice=4, coil=2)``.

    Called by every rank of an initialised process group (``parallel.launch``
    on one host, ``torchrun`` across hosts) with the same arguments. Axis
    sizes must multiply to at most the world size; excess ranks are left
    outside the mesh (``mesh.member`` is False there). An axis size of -1
    absorbs the remainder. ``device``: where each rank keeps its blocks;
    default the card, ``cuda:<rank modulo the number of cards>``; pass
    ``"cpu"`` to run on the host.

    The same layout on the same device returns the same Mesh (with its
    sub-groups and counters) until ``Mesh.close()`` or a new default group.
    """
    global _MESHES_OF
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(parallel.launch starts one per rank on this host)")
    ndev = dist.get_world_size()
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = max(1, ndev // known)
    total = int(np.prod(sizes))
    if total > ndev:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, only {ndev} available")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass device='cpu' to run the "
                "sharded path on the host")
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    if _MESHES_OF is not dist.group.WORLD:      # a new default group
        _MESHES.clear()
        _MESHES_OF = dist.group.WORLD
    key = (names, tuple(int(s) for s in sizes), str(torch.device(device)))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(names, sizes, device)
        mesh._key = key
    return mesh


class Placement:
    """Which mesh axis lies on which array dimension: ``spec[d]`` is an axis
    name or None for every leading dimension named (trailing dimensions are
    whole). The empty spec is a replicated array."""

    def __init__(self, mesh, spec=()):
        for name in spec:
            if name is not None and name not in mesh.shape:
                raise ValueError(f"mesh has no axis {name!r}: {mesh.shape}")
        self.mesh = mesh
        self.spec = tuple(spec)

    def _sharded(self):
        return [(d, name) for d, name in enumerate(self.spec)
                if name is not None]

    def local(self, x, dtype=None):
        """This rank's block of the global array ``x`` (numpy or tensor), as
        a contiguous tensor on the mesh's device. Only the block moves."""
        mesh = self.mesh
        mesh.require_member()
        index = [slice(None)] * len(self.spec)
        for d, name in self._sharded():
            p, n = mesh.shape[name], x.shape[d]
            if n % p:
                raise ValueError(
                    f"dim {d} of {tuple(x.shape)} is not divisible by the "
                    f"mesh axis {name}={p}")
            c = mesh.coords[name]
            index[d] = slice(c * (n // p), (c + 1) * (n // p))
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(
                np.asarray(x)[tuple(index)]))
        else:
            x = x[tuple(index)]
        return x.to(device=mesh.device, dtype=dtype).contiguous()

    def gather(self, x):
        """The global array of this rank's block ``x``, on every rank."""
        from .collectives import all_gather

        for d, name in self._sharded():
            x = all_gather(x, self.mesh, name, d)
        return x

    def __repr__(self):
        return f"Placement({self.spec})"


def replicated(mesh):
    return Placement(mesh, ())


def shard_along(mesh, axis_name, ndim, dim=0):
    """Placement putting mesh axis ``axis_name`` on array dim ``dim``."""
    spec = [None] * ndim
    spec[dim] = axis_name
    return Placement(mesh, spec)
