"""One BFS level over COO edges: the k-hop inner loop.

The wrapper of the CUDA kernel ``csrc/frontier.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/frontier.py::_frontier_kernel``.  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def frontier_expand(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    frontier: torch.Tensor, visited: torch.Tensor,
                    num_vertices: int) -> torch.Tensor:
    """Bool mask of the vertices reached from ``frontier`` over one valid
    edge and not in ``visited``.

    On the card the wrapper zeroes the mask, then persistent blocks
    (:func:`_build.scatter_grid`) stream the edges, reading a source only
    for a valid edge and a destination only for an edge from the frontier,
    and set a vertex's byte only when it is still 0 (see
    ``csrc/frontier.cu``).
    """
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
    blocks, _ = _build.scatter_grid(n_edges, _build.num_sms(dev))
    err = _build.library("frontier").repro_frontier_expand(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), out.data_ptr(), n_edges, n_front, num_vertices,
        blocks, _build.stream_ptr(dev))
    _build.check(err, "frontier_expand")
    frontier_expand.launches += 1
    return out


frontier_expand.launches = 0
