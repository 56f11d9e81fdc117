"""Distributed joins: hash-partitioned execution over ``torch.distributed``
(the port of ``repro.relational.distributed``).

Hash-partition both tables on the join key across the ``data`` axis of a
``DeviceMesh`` (one ``all_to_all_single`` per column and one for the
``valid`` mask), then run the shard-local sort-merge join.  Each function
runs once per rank, on that rank's block of rows: the counterpart of a
``shard_map`` body.  A table already partitioned on its key (a JS-MV view)
skips the exchange (``*_partitioned=True``).

The reference's docstring also promises a Bloom prefilter before the
exchange; its ``distributed_join`` does not implement one, and neither
does the port, which follows the code (ROADMAP.md §3).

Row routing: dest = key % n (an invalid row goes to dest n and is
dropped); a stable sort by dest; a row's rank is its position minus its
dest's start; it is kept if rank < cap, at slot dest*cap + rank.  The
per-destination capacity is static, ``max(8, int(cap_factor * local_rows
/ n + 7) // 8 * 8)``; rows beyond it are dropped (never wrapped) and
counted in the returned overflow.

On the card the shard-local join's probe is the ``sorted_probe`` kernel.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.mesh_axes import all_to_all, axis_group, axis_sizes
from repro_torch.relational.join import join_with_capacity
from repro_torch.relational.table import Table


def _route_local(tbl_cols: Dict[str, torch.Tensor], valid: torch.Tensor,
                 key: torch.Tensor, n: int, cap: int):
    """Scatter local rows into (n * cap,) per-destination buffers:
    (columns, valid, overflow) where overflow is the number of valid rows
    dropped at capacity (a 0-d int32 tensor)."""
    dev = key.device
    dest = torch.where(valid, torch.remainder(key, n),
                       torch.full_like(key, n))          # invalid -> dropped
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    starts = torch.searchsorted(
        sdest, torch.arange(n, dtype=sdest.dtype, device=dev))
    rank = torch.arange(dest.shape[0], dtype=torch.int32, device=dev) \
        - starts[torch.clamp(sdest, 0, n - 1)].to(torch.int32)
    svalid = valid[order]
    keep = (sdest < n) & (rank < cap)
    # a row not kept lands on a scratch slot past the buffers
    slot = torch.where(keep, sdest.to(torch.int32) * cap + rank,
                       n * cap).to(torch.int64)
    out_cols = {}
    for name, col in tbl_cols.items():
        buf = torch.zeros((n * cap + 1,), dtype=col.dtype, device=dev)
        buf.index_copy_(0, slot, col[order])
        out_cols[name] = buf[:-1]
    vbuf = torch.zeros((n * cap + 1,), dtype=torch.bool, device=dev)
    vbuf.index_copy_(0, slot, keep & svalid)
    overflow = ((sdest < n) & (rank >= cap) & svalid).sum(dtype=torch.int32)
    return out_cols, vbuf[:-1], overflow


def repartition_by_key(table: Table, key_col: str, mesh, axis: str = "data",
                       cap_factor: float = 2.0):
    """Hash-partition this rank's block of a row-sharded Table by
    ``key_col`` over ``axis``.

    Returns (table, overflow): this rank's block of n * cap rows (those
    whose ``key % n`` is this rank's index on ``axis``, from every rank, in
    rank order), and the number of rows dropped over the whole axis (0
    unless a rank sent more than ``cap`` rows to one destination).
    """
    import torch.distributed as dist

    n = axis_sizes(mesh)[axis]
    group = axis_group(mesh, axis)
    local_rows = table.capacity
    cap = max(8, int(cap_factor * local_rows / n + 7) // 8 * 8)
    bufs, vbuf, overflow = _route_local(table.columns, table.valid,
                                        table[key_col], n, cap)
    out_cols = {k: all_to_all(v, group) for k, v in bufs.items()}
    out_valid = all_to_all(vbuf, group)
    # psum over the axis, then the maximum over its ranks (which all hold
    # that sum), as the reference's jnp.max over the psums
    dist.all_reduce(overflow, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=group)
    return Table(columns=out_cols, valid=out_valid), overflow


def distributed_join(
    left: Table, right: Table, on: Sequence[Tuple[str, str]], mesh,
    axis: str = "data", capacity_per_shard: int = 1 << 14,
    left_partitioned: bool = False, right_partitioned: bool = False,
) -> Table:
    """Partitioned equi-join of this rank's blocks: repartition both sides
    on the first condition's keys, then join shard-locally into
    ``capacity_per_shard`` rows (the sort-merge join at that static
    capacity, as the reference's ``sort_merge_join``; its probe is the
    ``sorted_probe`` kernel on the card).

    ``*_partitioned=True`` skips the exchange for a side already
    hash-partitioned on its key (JS-MV views are stored this way, so their
    reuse is collective-free).
    """
    from repro_torch.kernels import ops as kops

    lcol, rcol = on[0]
    if not left_partitioned:
        left, _ = repartition_by_key(left, lcol, mesh, axis)
    if not right_partitioned:
        right, _ = repartition_by_key(right, rcol, mesh, axis)
    return join_with_capacity(
        left, right, list(on), "inner", capacity=capacity_per_shard,
        use_kernel=kops.resolve_use_kernel(None, left.device))[0]


__all__ = ["repartition_by_key", "distributed_join"]
