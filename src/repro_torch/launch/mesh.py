"""Device meshes over the ranks of a ``torch.distributed`` job.

Port of ``repro/launch/mesh.py``'s ``make_mesh`` and ``make_local_mesh``.
The reference lays a jax mesh over the devices of one process; here each
rank is a process, the default process group must be initialised first
(``torch.distributed.init_process_group``: its address, world size and
rank are the caller's), and the mesh lays the ranks out row-major, so on a
(data, model) mesh rank (d, m) is global rank ``d * model_size + m``.

Each axis gets process groups of its own, created here with ``timeout``
(a ``datetime.timedelta``; ``None`` keeps the backend's default), so a
collective that hangs on an axis fails after that time.  The production
meshes (``make_production_mesh``, ``mesh_to_slice``) are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              timeout=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group (its size must be the product of ``shape``).
    Every rank must call it, in the same order as its other group
    creations."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the "
                         f"process group has {world}")
    grid = torch.arange(world).reshape(tuple(shape))
    groups = []
    for dim in range(len(shape)):
        mine = None
        # every group of this axis, created by every rank in the same order
        for ranks in grid.movedim(dim, -1).reshape(-1, shape[dim]).tolist():
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = g
        groups.append(mine)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=tuple(axes))


def make_local_mesh(shape: Tuple[int, ...] = (1, 1),
                    axes: Tuple[str, ...] = ("data", "model"), *,
                    timeout=None) -> DeviceMesh:
    """Mesh over the ranks that exist (tests, smoke runs)."""
    return make_mesh(shape, axes, timeout=timeout)

