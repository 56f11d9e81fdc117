"""Bloom-filter build/probe: the join path's semi-join prefilter.

Wrappers of the CUDA kernels in ``csrc/bloom.cu``, which replace the Pallas
TPU kernels ``repro/kernels/bloom.py::_build_kernel`` / ``_probe_kernel``.
A CUDA tensor always launches a kernel (or raises); only a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.ref`.
:func:`bloom_prune_keys` is the probe kernel in its prune mode, the join's
``where(probe(bits, keys), keys, NULL_KEY)`` in one pass; its launches
count as ``bloom_probe``'s.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref

# Packed bits live in shared memory (num_bits / 8 bytes); the join path
# uses at most 16384 bits (kernels.ops.bloom_bits_for).
MAX_BITS = 1 << 18
# bloom_build's scratch: the packed words of a MAX_BITS bitset, then a ticket
SCRATCH_WORDS = MAX_BITS // 32 + 1
# The probe's launch (csrc/bloom.cu): tiles of 512 threads x 2 vectors of 4
# keys (kProbeTileKeys), at most 2 persistent blocks an SM
PROBE_TILE_KEYS = 4096
PROBE_BLOCKS_PER_SM = 2
# the join's null key (relational.table.NULL_KEY): what a pruned key becomes
NULL_KEY = 2**31 - 1

_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_SCRATCH_LOCK = threading.Lock()


def build_scratch(device, stream: int) -> torch.Tensor:
    """The int32 scratch of ``bloom_build`` on ``stream`` of ``device``:
    the packed bitset's words and a ticket (``SCRATCH_WORDS``).

    It is zeroed once, on that stream, when it is allocated, and every
    build leaves it zero, so a call needs no memset.  One per (device,
    stream): two builds in flight at once on two streams would OR into the
    same words and share one ticket counter (``csrc/bloom.cu``).  Made
    under a lock: threads launching on one stream share its scratch (their
    launches queue on that stream one after another), and none may drop
    another's while a kernel of it may be in flight.
    """
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cpu":
        raise ValueError("bloom_build: the scratch is for a card, not the CPU")
    key = (device, stream)
    with _SCRATCH_LOCK:
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
    _build.count_launch(bloom_build)
    return bits


def _probe(bits: torch.Tensor, keys: torch.Tensor, num_hashes: int,
           prune: bool, what: str) -> torch.Tensor:
    """One launch of the probe kernel: a bool test per key, or with
    ``prune`` the int32 key or ``NULL_KEY``."""
    dev = keys.device
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.int32 if prune else torch.bool,
                      device=dev)
    if n == 0:
        return out
    blocks, _ = _build.scatter_grid(n, _build.num_sms(dev),
                                    tile=PROBE_TILE_KEYS,
                                    per_sm=PROBE_BLOCKS_PER_SM)
    err = _build.library("bloom").repro_bloom_probe(
        bits.data_ptr(), keys.data_ptr(), out.data_ptr(), n, bits.shape[0],
        num_hashes, blocks, int(prune), _build.stream_ptr(dev))
    _build.check(err, what)
    _build.count_launch(bloom_probe)
    return out


def _check_probe(bits: torch.Tensor, keys: torch.Tensor, what: str):
    """The probe's operands; returns their device (a CPU or CUDA one)."""
    _build.check_input(bits, torch.int32, f"{what} bits")
    _build.check_input(keys, torch.int32, f"{what} keys", device=bits.device)
    _check_bits(bits.shape[0])
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def bloom_probe(bits: torch.Tensor, keys: torch.Tensor,
                num_hashes: int = 2) -> torch.Tensor:
    """Bool mask: True where the key is possibly present.

    On the card one launch a call: a few persistent blocks an SM pack the
    bitset into shared memory and stream the keys (``csrc/bloom.cu``).
    """
    if _check_probe(bits, keys, "bloom_probe").type == "cpu":
        return ref.bloom_probe(bits, keys, num_hashes)
    return _probe(bits, keys, num_hashes, False, "bloom_probe")


def bloom_prune_keys(bits: torch.Tensor, keys: torch.Tensor,
                     num_hashes: int = 2) -> torch.Tensor:
    """int32 ``keys`` where the probe hits, ``NULL_KEY`` where it misses:
    ``where(bloom_probe(bits, keys), keys, NULL_KEY)``, the join's pruning.

    On the card it is the probe kernel in its prune mode, one launch that
    reads each key once and writes the result, counted as a
    ``bloom_probe`` launch.
    """
    if _check_probe(bits, keys, "bloom_prune_keys").type == "cpu":
        null = torch.tensor(NULL_KEY, dtype=torch.int32)
        return torch.where(ref.bloom_probe(bits, keys, num_hashes), keys,
                           null)
    return _probe(bits, keys, num_hashes, True, "bloom_prune_keys")


bloom_build.launches = 0
bloom_probe.launches = 0
