"""Push SpMV over COO edges: the PageRank inner loop.

The wrapper of the CUDA kernel ``csrc/spmv.cu``, which replaces the Pallas
TPU kernel ``repro/kernels/spmv.py::_spmv_kernel``.  A CUDA tensor always
launches the kernel (or raises); only a CPU tensor takes the plain version
in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def edge_spmv(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
              x: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """float32 ``y[v] = sum of x[u]`` over valid edges ``(u -> v)``.

    On the card, persistent blocks (:func:`_build.scatter_grid`) sum each
    tile of edges per destination, first across the lanes of a warp, then
    in a shared-memory table, and flush the partial sums into ``y`` with
    float32 atomics, so the order of the sums changes from run to run (see
    ``csrc/spmv.cu`` for the error bound).
    """
    _build.check_coo(src, dst, valid, "edge_spmv")
    _build.check_input(x, torch.float32, "edge_spmv x", device=src.device)
    dev = src.device
    if dev.type == "cpu":
        return ref.edge_spmv(src, dst, valid, x, num_vertices)
    if dev.type != "cuda":
        raise ValueError(f"edge_spmv: unsupported device {dev}")
    y = torch.zeros((num_vertices,), dtype=torch.float32, device=dev)
    n_edges, nx = src.shape[0], x.shape[0]
    if n_edges == 0 or num_vertices == 0 or nx == 0:
        return y
    blocks, per_block = _build.scatter_grid(n_edges, _build.num_sms(dev))
    lib = _build.library("spmv")
    err = lib.repro_edge_spmv(
        ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(dst.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_int64(n_edges),
        ctypes.c_int64(nx), ctypes.c_int64(num_vertices),
        ctypes.c_int64(blocks), ctypes.c_int64(per_block),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "edge_spmv")
    _build.count_launch(edge_spmv)
    return y


edge_spmv.launches = 0
