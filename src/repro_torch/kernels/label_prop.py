"""One min-label propagation step over COO edges: the WCC inner loop.

The wrapper of the CUDA kernel ``csrc/label_prop.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/label_prop.py::_minlabel_kernel``.  A
CUDA tensor always launches the kernel (or raises); only a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def edge_min_label(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                   labels: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """int32 ``min(labels[v], min of labels[u] over valid (u -> v))``.

    On the card the output starts as a copy of ``labels[:num_vertices]``;
    persistent blocks (:func:`_build.scatter_grid`) skip every edge whose
    label is not below the current output, take the minimum per
    destination of each tile of edges in a shared-memory table, and flush
    it with atomics.  The result is exact (see ``csrc/label_prop.cu``).
    """
    _build.check_coo(src, dst, valid, "edge_min_label")
    _build.check_input(labels, torch.int32, "edge_min_label labels",
                       device=src.device)
    if labels.shape[0] < num_vertices:
        raise ValueError("edge_min_label: fewer labels than vertices")
    dev = src.device
    if dev.type == "cpu":
        return ref.edge_min_label(src, dst, valid, labels, num_vertices)
    if dev.type != "cuda":
        raise ValueError(f"edge_min_label: unsupported device {dev}")
    out = labels[:num_vertices].clone()
    n_edges = src.shape[0]
    if n_edges == 0 or num_vertices == 0:
        return out
    blocks, per_block = _build.scatter_grid(n_edges, _build.num_sms(dev))
    lib = _build.library("label_prop")
    err = lib.repro_edge_min_label(
        ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(dst.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()), ctypes.c_void_p(labels.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(n_edges),
        ctypes.c_int64(labels.shape[0]), ctypes.c_int64(num_vertices),
        ctypes.c_int64(blocks), ctypes.c_int64(per_block),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "edge_min_label")
    _build.count_launch(edge_min_label)
    return out


edge_min_label.launches = 0
