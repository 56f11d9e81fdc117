"""Join probe: (lo, hi) match ranges of probe keys in sorted build keys.

The wrapper of the CUDA kernel ``csrc/sorted_probe.cu``, which replaces
the Pallas TPU kernel ``repro/kernels/sorted_probe.py::_probe_kernel``.
A CUDA tensor always launches the kernel (or raises); only a CPU tensor
takes the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


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
    err = lib.repro_sorted_probe(
        ctypes.c_void_p(sorted_keys.data_ptr()),
        ctypes.c_void_p(probe_keys.data_ptr()),
        ctypes.c_void_p(lo.data_ptr()), ctypes.c_void_p(hi.data_ptr()),
        ctypes.c_int64(n_sorted), ctypes.c_int64(n_probe),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "sorted_probe")
    sorted_probe.launches += 1
    return lo, hi


sorted_probe.launches = 0
