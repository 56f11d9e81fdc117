"""Plain PyTorch versions of the hand-written kernels (the correctness contract).

Each function is the semantic reference its CUDA kernel is held against,
on the card by ``chip_smoke.py`` and the CUDA tests, and the path the
wrappers take for tensors on the CPU.  They match ``repro.kernels.ref`` of
the JAX package bit for bit, with two exceptions in the COO scatters: a
``dst`` (or histogram value) outside ``[0, n)`` contributes nothing, which
is the Pallas kernels' contract (the JAX reference wraps ``-1`` onto the
last vertex), and ``edge_spmv`` sums float32 in the order of the scatter.
"""
from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def _gather_index(src: torch.Tensor, size: int) -> torch.Tensor:
    """Source indices clipped into ``[0, size)``, as int64 for indexing
    (the Pallas edge kernels clip the same way before their gathers)."""
    return src.clamp(0, max(size - 1, 0)).to(torch.int64)


def sorted_probe(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """Two-sided binary search: (lo, hi) int32 match ranges per probe key."""
    lo = torch.searchsorted(sorted_keys, probe_keys, out_int32=True)
    hi = torch.searchsorted(sorted_keys, probe_keys, right=True,
                            out_int32=True)
    return lo, hi


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]``; zeros of ``col``'s dtype when ``col`` is empty (every
    slot is invalid)."""
    if col.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=col.dtype, device=col.device)
    return col[idx]


def join_expand(cum: torch.Tensor, match_counts: torch.Tensor,
                lo: torch.Tensor, order: torch.Tensor, capacity: int):
    """A join step's output slots ``[0, capacity)`` mapped to rows:
    (row, ridx, matched, valid).

    ``row[j] = #{i : cum[i] <= j}`` (a scatter of 1 at each left row's end,
    then a scan), clamped to the last row; ``rank = j - cum[row - 1]`` is
    the slot's place among its row's outputs; ``matched = rank <
    match_counts[row]``; ``ridx = order[clamp(lo[row] + rank, 0, rc - 1)]``
    (0 when ``order`` is empty); ``valid = j < cum[-1]``.  Output is
    prefix-compacted: a slot past the total is padding.
    """
    dev = cum.device
    n = cum.shape[0]
    slots = torch.arange(capacity, dtype=torch.int64, device=dev)
    mark = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    mark.index_add_(0, torch.clamp(cum, 0, capacity), torch.ones_like(cum))
    row = torch.clamp(torch.cumsum(mark, 0)[:capacity], 0, max(n - 1, 0))
    before = torch.cat([cum.new_zeros(1), cum[:-1]]) if n else cum
    rank = slots - take(before, row)
    matched = rank < take(match_counts, row)
    rpos = torch.clamp(take(lo, row) + rank, 0, max(order.shape[0] - 1, 0))
    total = cum[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    return row, take(order, rpos), matched, slots < total


def segment_counts(values: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Masked histogram: int32 counts of the valid ``values`` per bin.

    A value outside ``[0, num_segments)`` is not counted.  The JAX
    reference's ``mode="drop"`` scatter would wrap ``-1`` onto the last bin;
    ``index_add_`` would raise on it, so out-of-range slots are masked
    first, which is the Pallas kernel's contract.
    """
    keep = valid & (values >= 0) & (values < num_segments)
    idx = torch.where(keep, values, torch.zeros_like(values)).to(torch.int64)
    counts = torch.zeros((num_segments,), dtype=torch.int32,
                         device=values.device)
    return counts.index_add_(0, idx, keep.to(torch.int32))


def _edge_keep(dst: torch.Tensor, valid: torch.Tensor, n: int):
    """(keep mask, int64 scatter index): valid edges with ``dst`` in
    ``[0, n)``; masked edges scatter a neutral value into slot 0."""
    keep = valid & (dst >= 0) & (dst < n)
    idx = torch.where(keep, dst, torch.zeros_like(dst)).to(torch.int64)
    return keep, idx


def edge_spmv(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
              x: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Push SpMV over COO edges, float32: ``y[v] = sum_{valid (u,v)} x[u]``."""
    keep, idx = _edge_keep(dst, valid, num_vertices)
    xf = x.to(torch.float32)
    contrib = torch.where(keep, xf[_gather_index(src, xf.shape[0])],
                          torch.zeros((), dtype=torch.float32,
                                      device=x.device))
    y = torch.zeros((num_vertices,), dtype=torch.float32, device=x.device)
    return y.index_add_(0, idx, contrib)


def edge_min_label(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                   labels: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """One min-label step: ``min(labels[v], min_{valid (u,v)} labels[u])``."""
    keep, idx = _edge_keep(dst, valid, num_vertices)
    lab = labels.to(torch.int32)
    incoming = torch.where(keep, lab[_gather_index(src, lab.shape[0])],
                           torch.full((), _INT32_MAX, dtype=torch.int32,
                                      device=lab.device))
    out = lab[:num_vertices].clone()
    return out.scatter_reduce_(0, idx, incoming, reduce="amin",
                               include_self=True)


def frontier_expand(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    frontier: torch.Tensor, visited: torch.Tensor,
                    num_vertices: int) -> torch.Tensor:
    """One BFS level: bool mask of vertices reached from the frontier over
    a valid edge and not yet visited."""
    keep, idx = _edge_keep(dst, valid, num_vertices)
    front = frontier.to(torch.bool)
    hit = keep & front[_gather_index(src, front.shape[0])]
    reached = torch.zeros((num_vertices,), dtype=torch.int32,
                          device=dst.device)
    reached.scatter_reduce_(0, idx, hit.to(torch.int32), reduce="amax")
    return (reached > 0) & ~visited.to(torch.bool)[:num_vertices]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Dense GQA attention oracle for the flash kernel, in float32.

    ``q`` (B, Sq, Hq, Dh), ``k``/``v`` (B, Sk, Hkv, Dh); query head ``h``
    reads kv head ``h // (Hq // Hkv)``.  No positions argument: query row
    ``i`` is position ``i + q_offset`` and key index ``j`` position ``j``,
    as in the kernel's masks (``j < Sk``, plus ``p >= j`` when causal, plus
    ``p - j < window``, for ``p = i + q_offset``).  The output is in q's
    dtype.  A query row with no key to attend (only when Sq > Sk under a
    window) is 0, the kernel's contract; the JAX reference averages all
    keys there.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = (q.to(torch.float32) / math.sqrt(dh)).reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    out = out.masked_fill(~mask.any(dim=-1)[None, :, None, None, None], 0.0)
    return out.reshape(b, sq, hq, dh).to(q.dtype)
