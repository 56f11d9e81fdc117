"""Plain PyTorch versions of the hand-written kernels (the correctness contract).

Each function is the semantic reference its CUDA kernel is held against,
on the card by ``chip_smoke.py`` and the CUDA tests, and the path the
wrappers take for tensors on the CPU.  They match
``repro.kernels.ref`` of the JAX package bit for bit.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def sorted_probe(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """Two-sided binary search: (lo, hi) int32 match ranges per probe key."""
    lo = torch.searchsorted(sorted_keys, probe_keys, out_int32=True)
    hi = torch.searchsorted(sorted_keys, probe_keys, right=True,
                            out_int32=True)
    return lo, hi


def _bloom_hashes(keys: torch.Tensor, num_bits: int, num_hashes: int):
    """uint32 multiplicative hashes -> (num_hashes, N) int64 bit positions.

    uint32 wrap is reproduced in int64: an int64 product wraps mod 2**64,
    so masking its low 32 bits after every multiply and add is exact.
    """
    ks = keys.to(torch.int64) & _U32          # reinterpret int32 as uint32
    out = []
    for i in range(num_hashes):
        h = (ks * (2654435761 + 40503 * i)) & _U32
        h = (h + i * 97) & _U32
        h = h ^ (h >> 15)
        out.append(h % num_bits)
    return torch.stack(out) if out else ks.new_zeros((0,) + ks.shape)


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, num_bits: int,
                num_hashes: int = 2) -> torch.Tensor:
    """Bloom bitset: int32 0/1 per bit, set for every valid key's hashes."""
    pos = _bloom_hashes(keys, num_bits, num_hashes)
    bits = torch.zeros((num_bits,), dtype=torch.int32, device=keys.device)
    v = valid.to(torch.int32)
    for i in range(num_hashes):
        bits.scatter_reduce_(0, pos[i], v, reduce="amax")
    return bits


def bloom_probe(bits: torch.Tensor, keys: torch.Tensor,
                num_hashes: int = 2) -> torch.Tensor:
    """True where the key is possibly present (no false negatives)."""
    num_bits = bits.shape[0]
    pos = _bloom_hashes(keys, num_bits, num_hashes)
    hit = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(num_hashes):
        hit = hit & (bits[pos[i]] > 0)
    return hit
