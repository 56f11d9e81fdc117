"""One BFS level over COO edges: the k-hop inner loop.

The wrapper of the CUDA kernel ``csrc/frontier.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/frontier.py::_frontier_kernel``.  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def frontier_expand(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    frontier: torch.Tensor, visited: torch.Tensor,
                    num_vertices: int) -> torch.Tensor:
    """Bool mask of the vertices reached from ``frontier`` over one valid
    edge and not in ``visited``."""
    _build.check_coo(src, dst, valid, "frontier_expand")
    _build.check_input(frontier, torch.bool, "frontier_expand frontier",
                       device=src.device)
    _build.check_input(visited, torch.bool, "frontier_expand visited",
                       device=src.device)
    if visited.shape[0] < num_vertices:
        raise ValueError("frontier_expand: visited shorter than num_vertices")
    dev = src.device
    if dev.type == "cpu":
        return ref.frontier_expand(src, dst, valid, frontier, visited,
                                   num_vertices)
    if dev.type != "cuda":
        raise ValueError(f"frontier_expand: unsupported device {dev}")
    out = torch.zeros((num_vertices,), dtype=torch.bool, device=dev)
    n_edges, n_front = src.shape[0], frontier.shape[0]
    if n_edges == 0 or num_vertices == 0 or n_front == 0:
        return out
    lib = _build.library("frontier")
    err = lib.repro_frontier_expand(
        ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(dst.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(frontier.data_ptr()),
        ctypes.c_void_p(visited.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(n_edges), ctypes.c_int64(n_front),
        ctypes.c_int64(num_vertices),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "frontier_expand")
    frontier_expand.launches += 1
    return out


frontier_expand.launches = 0
