"""Masked histogram: the CSR build's row counts and the degree statistics.

The wrapper of the CUDA kernel ``csrc/segment_csr.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/segment_csr.py::_hist_kernel``.  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def segment_counts(values: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """int32 counts of the valid ``values`` in each bin of
    ``[0, num_segments)``; values outside that range are not counted.

    On the card, persistent blocks (:func:`_build.scatter_grid`) count
    their tiles of values per bin in a shared-memory table and flush the
    counts into the output with global atomics (see
    ``csrc/segment_csr.cu``).
    """
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
    blocks, _ = _build.scatter_grid(n, _build.num_sms(dev))
    err = _build.library("segment_csr").repro_segment_counts(
        values.data_ptr(), valid.data_ptr(), counts.data_ptr(), n,
        num_segments, blocks, _build.stream_ptr(dev))
    _build.check(err, "segment_counts")
    _build.count_launch(segment_counts)
    return counts


segment_counts.launches = 0
