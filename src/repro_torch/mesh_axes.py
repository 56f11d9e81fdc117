"""Mesh axes and the collectives the sharded functions share.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` (or a
stand-in with ``mesh_dim_names`` and ``shape``).  The axis helpers read
its axis names, sizes and this rank's coordinate; the two collectives are
``jax.lax.all_to_all`` and a tiled ``jax.lax.all_gather`` over one axis's
process group.  Both the models and the relational layer use them, and
``repro_torch.launch.mesh`` re-exports the axis helpers.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def axis_group(mesh, axes):
    """The process group of one axis, or of several axes flattened (as
    ``shard_map``'s collectives over a tuple of axes): ``None`` when
    ``axes`` is empty."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group(0)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (major to minor, as
    ``jax.lax.axis_index`` over a tuple of axes)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes, coord = axis_sizes(mesh), mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def axes_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (1 for none)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)``: block j of the
    leading axis goes to rank j of ``group``; blocks arrive in rank
    order."""
    import torch.distributed as dist

    x = x.contiguous()            # empty_like keeps a view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)`` over ``group``'s
    ranks in order."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


__all__ = ["axis_sizes", "axis_group", "axis_index", "axes_size",
           "all_to_all", "all_gather"]
