"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` on the
current default process group: functions, not module-level constants, so
importing this module initialises nothing.  Every function that plans a
layout reads only a mesh's axis names and sizes (:func:`axis_sizes`, one
of the axis helpers this module re-exports from ``repro_torch.mesh_axes``),
so a stand-in with ``mesh_dim_names`` and ``shape`` plans like a mesh.

The JAX package's ``mesh_context`` (an ambient mesh) has no counterpart:
every sharded function of the port takes its mesh as an argument.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.mesh_axes import axes_size, axis_group, axis_index, \
    axis_sizes

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    """``device=None`` means the CUDA card (and raises without one), as
    every entry point of the port; ``"cpu"`` asks for the host (``gloo`` or
    a fake process group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.relational.table import resolve_device

    kind = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised process "
            "group (torch.distributed.init_process_group)")
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {need} ranks, the "
            f"process group has {dist.get_world_size()}")
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks a pod, ``("data", "model")``; 2 pods = 512 ranks,
    ``("pod", "data", "model")``, when ``multi_pod``.  The default process
    group must have exactly that many ranks (the dry run gives it a fake
    one)."""
    shape, names = PRODUCTION_SHAPE[multi_pod]
    return _mesh(shape, names, device)


def make_host_mesh(device=None):
    """A 1x1 ``("data", "model")`` mesh on the current process group (of
    one rank)."""
    return _mesh((1, 1), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (the pod axis folds into DP)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


__all__ = ["make_production_mesh", "make_host_mesh", "dp_axes",
           "axis_sizes", "axis_group", "axis_index", "axes_size",
           "PRODUCTION_SHAPE"]
