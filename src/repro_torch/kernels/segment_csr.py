"""Masked histogram: the CSR build's row counts and the degree statistics.

The wrapper of the CUDA kernel ``csrc/segment_csr.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/segment_csr.py::_hist_kernel``.  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def segment_counts(values: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """int32 counts of the valid ``values`` in each bin of
    ``[0, num_segments)``; values outside that range are not counted."""
    _build.check_input(values, torch.int32, "segment_counts values")
    _build.check_input(valid, torch.bool, "segment_counts valid",
                       device=values.device)
    if valid.shape != values.shape:
        raise ValueError("segment_counts: values and valid differ in length")
    if num_segments < 0:
        raise ValueError(f"segment_counts: num_segments {num_segments} < 0")
    dev = values.device
    if dev.type == "cpu":
        return ref.segment_counts(values, valid, num_segments)
    if dev.type != "cuda":
        raise ValueError(f"segment_counts: unsupported device {dev}")
    n = values.shape[0]
    counts = torch.zeros((num_segments,), dtype=torch.int32, device=dev)
    if n == 0 or num_segments == 0:
        return counts
    lib = _build.library("segment_csr")
    err = lib.repro_segment_counts(
        ctypes.c_void_p(values.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(counts.data_ptr()), ctypes.c_int64(n),
        ctypes.c_int64(num_segments),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "segment_counts")
    segment_counts.launches += 1
    return counts


segment_counts.launches = 0
