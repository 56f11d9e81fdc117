"""Bloom-filter build/probe: the join path's semi-join prefilter.

Wrappers of the CUDA kernels in ``csrc/bloom.cu``, which replace the Pallas
TPU kernels ``repro/kernels/bloom.py::_build_kernel`` / ``_probe_kernel``.
A CUDA tensor always launches a kernel (or raises); only a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref

# Packed bits live in shared memory (num_bits / 8 bytes); the join path
# uses at most 16384 bits (kernels.ops.bloom_bits_for).
MAX_BITS = 1 << 18
# bloom_build's scratch: the packed words of a MAX_BITS bitset, then a ticket
SCRATCH_WORDS = MAX_BITS // 32 + 1

_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def build_scratch(device, stream: int) -> torch.Tensor:
    """The int32 scratch of ``bloom_build`` on ``stream`` of ``device``:
    the packed bitset's words and a ticket (``SCRATCH_WORDS``).

    It is zeroed once, on that stream, when it is allocated, and every
    build leaves it zero, so a call needs no memset.  One per (device,
    stream): two builds in flight at once on two streams would OR into the
    same words and share one ticket counter (``csrc/bloom.cu``).
    """
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cpu":
        raise ValueError("bloom_build: the scratch is for a card, not the CPU")
    key = (device, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = torch.zeros(
            (SCRATCH_WORDS,), dtype=torch.int32, device=device)
    return scratch


def _check_bits(num_bits: int) -> None:
    if not 0 < num_bits <= MAX_BITS:
        raise ValueError(f"bloom: num_bits {num_bits} not in [1, {MAX_BITS}]")


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, num_bits: int,
                num_hashes: int = 2) -> torch.Tensor:
    """int32 0/1 bitset of ``num_bits`` with the hashes of the valid keys.

    On the card one launch a call: persistent blocks
    (:func:`_build.scatter_grid`) combine their bitsets through the
    stream's :func:`build_scratch`, and the last block writes the output.
    """
    _build.check_input(keys, torch.int32, "bloom_build keys")
    _build.check_input(valid, torch.bool, "bloom_build valid",
                       device=keys.device)
    if valid.shape != keys.shape:
        raise ValueError("bloom_build: keys and valid differ in length")
    _check_bits(num_bits)
    dev = keys.device
    if dev.type == "cpu":
        return ref.bloom_build(keys, valid, num_bits, num_hashes)
    if dev.type != "cuda":
        raise ValueError(f"bloom_build: unsupported device {dev}")
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((num_bits,), dtype=torch.int32, device=dev)
    bits = torch.empty((num_bits,), dtype=torch.int32, device=dev)
    stream = _build.stream_ptr(dev)
    scratch = build_scratch(dev, stream).data_ptr()
    blocks, _ = _build.scatter_grid(n, _build.num_sms(dev))
    err = _build.library("bloom").repro_bloom_build(
        keys.data_ptr(), valid.data_ptr(), scratch,
        scratch + 4 * (SCRATCH_WORDS - 1), bits.data_ptr(), n, num_bits,
        num_hashes, blocks, stream)
    _build.check(err, "bloom_build")
    bloom_build.launches += 1
    return bits


def bloom_probe(bits: torch.Tensor, keys: torch.Tensor,
                num_hashes: int = 2) -> torch.Tensor:
    """Bool mask: True where the key is possibly present."""
    _build.check_input(bits, torch.int32, "bloom_probe bits")
    _build.check_input(keys, torch.int32, "bloom_probe keys",
                       device=bits.device)
    num_bits = bits.shape[0]
    _check_bits(num_bits)
    dev = keys.device
    if dev.type == "cpu":
        return ref.bloom_probe(bits, keys, num_hashes)
    if dev.type != "cuda":
        raise ValueError(f"bloom_probe: unsupported device {dev}")
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.library("bloom")
    err = lib.repro_bloom_probe(
        ctypes.c_void_p(bits.data_ptr()), ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(n),
        ctypes.c_int64(num_bits), ctypes.c_int64(num_hashes),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "bloom_probe")
    bloom_probe.launches += 1
    return out


bloom_build.launches = 0
bloom_probe.launches = 0
