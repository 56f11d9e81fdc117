"""The join library's wrappers: the probe and the pair expansion.

``sorted_probe`` gives the (lo, hi) match ranges of probe keys in sorted
build keys; its CUDA kernel (``csrc/sorted_probe.cu``) replaces the Pallas
TPU kernel ``repro/kernels/sorted_probe.py::_probe_kernel``.
``join_expand`` maps a join step's output slots to left and right rows
without atomics (the same source; it replaces no TPU kernel).  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Keys of the shared-memory fence each block of the kernel searches first
# (kMaxFence in csrc/sorted_probe.cu): 32 KB of int32.
MAX_FENCE = 8192
# Output slots a block of join_expand's kernel takes (kExpandTile).
EXPAND_TILE = 2048


def fence_stride(n_sorted: int) -> int:
    """Build keys between two fence keys: the least stride whose fence
    ``sorted[::stride]`` has at most :data:`MAX_FENCE` keys (1, the whole
    build side, when ``n_sorted <= MAX_FENCE``)."""
    if n_sorted <= 0:
        raise ValueError(f"sorted_probe: no fence for {n_sorted} build keys")
    return -(-n_sorted // MAX_FENCE)


def sorted_probe(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """(lo, hi) int32 match ranges of each probe key in ``sorted_keys``.

    Both inputs are contiguous 1-D int32 tensors on one device;
    ``sorted_keys`` ascends.  ``lo``/``hi`` equal the left/right bisections.
    """
    _build.check_input(sorted_keys, torch.int32, "sorted_probe sorted_keys")
    _build.check_input(probe_keys, torch.int32, "sorted_probe probe_keys",
                       device=sorted_keys.device)
    dev = sorted_keys.device
    if dev.type == "cpu":
        return ref.sorted_probe(sorted_keys, probe_keys)
    if dev.type != "cuda":
        raise ValueError(f"sorted_probe: unsupported device {dev}")
    n_sorted, n_probe = sorted_keys.shape[0], probe_keys.shape[0]
    if n_sorted >= 2**31:
        raise ValueError("sorted_probe: int32 ranges need < 2**31 build keys")
    if n_probe == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=dev)
        return empty, empty
    if n_sorted == 0:
        zeros = torch.zeros((n_probe,), dtype=torch.int32, device=dev)
        return zeros, zeros.clone()
    lib = _build.library("sorted_probe")
    lo = torch.empty((n_probe,), dtype=torch.int32, device=dev)
    hi = torch.empty((n_probe,), dtype=torch.int32, device=dev)
    stride = fence_stride(n_sorted)
    fence = torch.empty((-(-n_sorted // stride),), dtype=torch.int32,
                        device=dev)
    err = lib.repro_sorted_probe(
        ctypes.c_void_p(sorted_keys.data_ptr()),
        ctypes.c_void_p(probe_keys.data_ptr()),
        ctypes.c_void_p(lo.data_ptr()), ctypes.c_void_p(hi.data_ptr()),
        ctypes.c_void_p(fence.data_ptr()),
        ctypes.c_int64(n_sorted), ctypes.c_int64(n_probe),
        ctypes.c_int64(stride),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "sorted_probe")
    _build.count_launch(sorted_probe)
    return lo, hi


sorted_probe.launches = 0


def join_expand(cum: torch.Tensor, match_counts: torch.Tensor,
                lo: torch.Tensor, order: torch.Tensor, capacity: int):
    """(row, ridx, matched, valid) of a join step's output slots.

    ``cum`` is the inclusive int64 cumsum of the left rows' output counts;
    ``match_counts`` and ``lo`` (int32, one a left row) are the rows' match
    counts and first match in the sorted build side; ``order`` (int64) maps
    a sorted build position to its right row.  For each slot of
    ``[0, capacity)``: its left row (int64), its right row (int64),
    whether it holds a match, and whether it lies below the step's total.
    Equal, bit for bit, to :func:`repro_torch.kernels.ref.join_expand`.
    """
    _build.check_input(cum, torch.int64, "join_expand cum")
    dev = cum.device
    n = cum.shape[0]
    for t, dtype, what in ((match_counts, torch.int32, "match_counts"),
                           (lo, torch.int32, "lo")):
        _build.check_input(t, dtype, f"join_expand {what}", device=dev)
        if t.shape[0] != n:
            raise ValueError(f"join_expand: {what} has {t.shape[0]} rows, "
                             f"cum {n}")
    _build.check_input(order, torch.int64, "join_expand order", device=dev)
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError(f"join_expand: capacity {capacity}")
    if dev.type == "cpu":
        return ref.join_expand(cum, match_counts, lo, order, capacity)
    if dev.type != "cuda":
        raise ValueError(f"join_expand: unsupported device {dev}")
    if n >= 2**31:
        raise ValueError("join_expand: int32 row bounds need < 2**31 rows")
    row = torch.empty((capacity,), dtype=torch.int64, device=dev)
    ridx = torch.empty((capacity,), dtype=torch.int64, device=dev)
    matched = torch.empty((capacity,), dtype=torch.bool, device=dev)
    valid = torch.empty((capacity,), dtype=torch.bool, device=dev)
    if capacity == 0:
        return row, ridx, matched, valid
    lib = _build.library("sorted_probe")
    n_bounds = -(-capacity // EXPAND_TILE) + 1
    bounds = torch.empty((n_bounds,), dtype=torch.int32, device=dev)
    err = lib.repro_join_expand(
        *(ctypes.c_void_p(t.data_ptr()) for t in (
            cum, match_counts, lo, order, bounds, row, ridx, matched,
            valid)),
        ctypes.c_int64(n), ctypes.c_int64(order.shape[0]),
        ctypes.c_int64(capacity), ctypes.c_int64(n_bounds),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "join_expand")
    _build.count_launch(join_expand)
    return row, ridx, matched, valid


join_expand.launches = 0
