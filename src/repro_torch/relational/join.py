"""Sort-merge joins with static output shapes.

PostgreSQL (the paper's base system) evaluates every join with hash
build/probe over disk pages.  Here every join is

    sort(right keys)  ->  two-sided bisection of the left keys  ->
    static-capacity pair expansion

which keeps every shape static, so a whole plan unit runs on the device
with one host sync at its end.  ``N``-to-``N`` joins are handled exactly:
each left row expands into ``hi - lo`` output rows via a cumsum and a
mapping of output slots to rows (``kernels.ops.join_expand``).

Outer-join semantics follow Theorem 4.3 of the paper: a left row with no
match emits exactly one output row whose right side is *null*, signalled by
an indicator column (never by sentinel data values).

Index arithmetic (cumsums, gather positions) runs in ``int64``; every
stored output column keeps the dtype of its source column, and indicators
are ``bool``.
"""
from __future__ import annotations

from typing import Collection, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.relational.table import NULL_KEY, Table

NULL_KEY64 = np.int32(2**31 - 1)


def _null_like(k: torch.Tensor) -> torch.Tensor:
    """0-d int32 ``NULL_KEY`` on ``k``'s device (keeps ``where`` in int32)."""
    return torch.tensor(int(NULL_KEY64), dtype=torch.int32, device=k.device)


def composite_key(table: Table, cols: Sequence[str]) -> torch.Tensor:
    """Null-aware int32 sort key for a single key column.

    Invalid rows map to ``NULL_KEY64`` (int32 max) so they sort last and never
    match a valid key (valid ids must be < 2**31-1).  Joins with multiple
    equality conditions sort/search on the *first* condition and apply the
    remaining conditions as exact post-filters — single-column equijoins are
    the common case in graph-model workloads, and this keeps all keys in
    int32 without lossy packing.
    """
    if len(cols) != 1:
        raise ValueError(f"composite_key takes exactly 1 column, got {cols}")
    k = table[cols[0]].to(torch.int32)
    return torch.where(table.valid, k, _null_like(k))


def join_count(
    left: Table,
    right: Table,
    on_left: Tuple[str, ...],
    on_right: Tuple[str, ...],
) -> torch.Tensor:
    """Exact inner-join output cardinality on the single sort-key column.

    Only the first equality condition is counted — the same contract as
    :func:`composite_key` / :func:`sort_merge_join`, where exactly one
    column forms the sort key and any further conditions are exact
    post-filters.  This is the upper bound the two-phase eager path sizes
    its output capacity with (post-filters only shrink the result).
    """
    lk = composite_key(left, on_left)
    rk = composite_key(right, on_right)
    rk_sorted = torch.sort(rk).values
    lo = torch.searchsorted(rk_sorted, lk, out_int32=True)
    hi = torch.searchsorted(rk_sorted, lk, right=True, out_int32=True)
    counts = torch.where(left.valid & (lk != int(NULL_KEY64)), hi - lo,
                         torch.zeros_like(lo))
    return counts.sum(dtype=torch.int64)


def _probe_ranges(rk_sorted: torch.Tensor, lk: torch.Tensor,
                  use_kernel: bool):
    """(lo, hi) match ranges; the ``sorted_probe`` kernel or a bisection.

    The plain path runs a single bisection over ``[lk, lk + 1]``: keys are
    int32, so ``right`` of ``k`` equals ``left`` of ``k + 1``.  The only key
    that wraps is ``NULL_KEY64`` (int32 max), whose rows are masked out of
    the match counts anyway.
    """
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.sorted_probe(rk_sorted, lk)
    n = lk.shape[0]
    pos = torch.searchsorted(rk_sorted, torch.cat([lk, lk + 1]),
                             out_int32=True)
    return pos[:n], pos[n:]


def _join_core(
    left: Table,
    right: Table,
    lk: torch.Tensor,
    rk: torch.Tensor,
    how: str,
    capacity: int,
    indicator: Optional[str],
    use_kernel: bool,
    gather: Optional[Collection[str]] = None,
) -> Tuple[Table, torch.Tensor]:
    """Static-capacity pair expansion; returns (table, required_rows).

    ``required_rows`` is the exact (on-device, pre-truncation) number of
    output slots the join needed; the result is silently prefix-truncated
    when it exceeds ``capacity``, which callers detect by comparing the two.
    Only the columns named in ``gather`` (every column when ``None``) are
    gathered into the output.
    """
    order = torch.argsort(rk, stable=True)
    rk_sorted = rk[order]
    lo, hi = _probe_ranges(rk_sorted, lk, use_kernel)
    zero = torch.zeros_like(lo)
    match_counts = torch.where(left.valid & (lk != int(NULL_KEY64)),
                               hi - lo, zero)
    if how == "inner":
        counts = match_counts
    elif how == "left_outer":
        counts = torch.where(left.valid, torch.clamp(match_counts, min=1),
                             zero)
    else:
        raise ValueError(f"unknown join kind {how!r}")

    cum = torch.cumsum(counts, 0, dtype=torch.int64)          # inclusive
    total = cum[-1] if cum.shape[0] else cum.new_zeros(())
    # output slots -> (left row, right row, matched, valid), prefix-compacted
    from repro_torch.kernels import ops as kops

    expand = kops.join_expand if use_kernel else ref.join_expand
    row, ridx, matched, valid = expand(cum, match_counts, lo, order, capacity)

    cols = {}
    for name, col in left.columns.items():
        if gather is None or name in gather:
            cols[name] = ref.take(col, row)
    for name, col in right.columns.items():
        if name in left.columns:
            raise ValueError(
                f"column collision on {name!r}; prefix aliases first")
        if gather is None or name in gather:
            cols[name] = ref.take(col, ridx)
    out_valid = valid
    if how == "left_outer":
        ind = matched & valid
        if indicator is not None:
            cols[indicator] = ind
    else:
        out_valid = valid & matched  # matched is all-True for valid inner slots
    return Table(columns=cols, valid=out_valid), total


def join_with_capacity(
    left: Table,
    right: Table,
    on: Sequence[Tuple[str, str]],
    how: str = "inner",
    *,
    capacity: int,
    indicator: Optional[str] = None,
    use_kernel: bool = False,
    bloom_bits: int = 0,
    gather: Optional[Collection[str]] = None,
) -> Tuple[Table, torch.Tensor]:
    """Join at a static capacity with no host syncs; returns (table, required).

    The building block of the compiled pipeline executor
    (:mod:`repro_torch.core.pipeline`).  ``required`` is the on-device exact
    number of output slots the first-key expansion needed; if it exceeds
    ``capacity`` the output was truncated and the caller must re-execute at
    a larger capacity (the pipeline's overflow-retry).  ``use_kernel``
    routes the probe through the ``sorted_probe`` kernel and the pair
    expansion through ``join_expand``;
    ``bloom_bits > 0`` additionally prunes probe rows through a Bloom-filter
    semi-join *before* the capacity expansion.  Bloom filters have no false
    negatives, so pruning is exact for inner joins and turns outer-join
    prunees into (correct) unmatched null rows.  ``gather`` names the
    columns of either side to carry into the output (``None``: all of
    them); the columns of the conditions after the first are gathered too,
    since they are post-filters of the expansion.
    """
    on = list(on)
    key_on, rest = on[:1], on[1:]
    if gather is not None and rest:
        gather = set(gather).union(*rest)
    on_left = tuple(l for l, _ in key_on)
    on_right = tuple(r for _, r in key_on)
    lk = composite_key(left, on_left)
    rk = composite_key(right, on_right)
    if bloom_bits:
        from repro_torch.kernels import ops as kops

        bits = kops.bloom_build(rk, right.valid & (rk != int(NULL_KEY64)),
                                bloom_bits)
        lk = kops.bloom_prune_keys(bits, lk)
    out, total = _join_core(left, right, lk, rk, how, capacity, indicator,
                            use_kernel, gather)
    for lcol, rcol in rest:
        keep = out[lcol] == out[rcol]
        if how == "left_outer" and indicator is not None:
            # extra predicates only constrain *matched* rows
            out = out.with_columns(**{indicator: out[indicator] & keep})
        else:
            out = out.mask(keep)
    return out, total


def left_outer_with_capacity(
    left: Table,
    right: Table,
    on: Sequence[Tuple[str, str]],
    indicator: str,
    capacity: int,
    use_kernel: bool = False,
    bloom_bits: int = 0,
    gather: Optional[Collection[str]] = None,
) -> Tuple[Table, torch.Tensor]:
    """Exact left-outer join at static capacity; (table, required).

    Mirrors :func:`left_outer_join`: with one condition this is the native
    outer path at ``capacity``; with several, the exact first-key inner
    expansion (at ``capacity``) plus exactly one null row appended per
    unmatched left row (output capacity ``capacity + left.capacity``, which
    is static and can never overflow — ``required`` tracks the inner part).
    ``gather`` is :func:`join_with_capacity`'s; both parts carry the same
    columns.
    """
    on = list(on)
    if len(on) == 1:
        return join_with_capacity(
            left, right, on, how="left_outer", capacity=capacity,
            indicator=indicator, use_kernel=use_kernel,
            bloom_bits=bloom_bits, gather=gather)
    dev = left.device
    rowid = "__rowid__"
    rowids = torch.arange(left.capacity, dtype=torch.int32, device=dev)
    lt = left.with_columns(**{rowid: rowids})
    inner, total = join_with_capacity(
        lt, right, on, how="inner", capacity=capacity,
        use_kernel=use_kernel, bloom_bits=bloom_bits,
        gather=None if gather is None else {*gather, rowid})
    hits = torch.zeros((left.capacity,), dtype=torch.int32, device=dev)
    if left.capacity:
        hits.index_add_(0, inner[rowid].to(torch.int64),
                        inner.valid.to(torch.int32))
    unmatched = left.valid & (hits == 0)

    matched_part = inner.with_columns(**{indicator: inner.valid})

    def unmatched_col(name: str) -> torch.Tensor:
        if name in left.columns:
            return left[name]
        dtype = torch.bool if name == indicator else right[name].dtype
        return torch.zeros((left.capacity,), dtype=dtype, device=dev)

    cols = {
        n: torch.cat([matched_part[n], unmatched_col(n)])
        for n in matched_part.column_names() if n != rowid
    }
    valid = torch.cat([matched_part.valid, unmatched])
    return Table(columns=cols, valid=valid), total


def round_capacity(n: int) -> int:
    """Smallest pow-2 capacity strictly above ``n`` (min 8).

    The one capacity-bucketing rule shared by the eager two-phase path,
    the compiled pipeline, and incremental delta tables — bucketing keeps
    shapes stable across requests (and across refreshes at similar churn),
    which is what makes unit caches hit.
    """
    return max(8, int(1 << int(np.ceil(np.log2(max(n, 1) + 1)))))


_round_capacity = round_capacity  # historical private name, kept for callers


def sort_merge_join(
    left: Table,
    right: Table,
    on: Sequence[Tuple[str, str]],
    how: str = "inner",
    capacity: Optional[int] = None,
    indicator: Optional[str] = None,
) -> Table:
    """Join two tables on equality conditions ``[(lcol, rcol), ...]``.

    The first condition forms the (single-column) sort key; any further
    conditions are applied as an exact post-filter — the contract
    :func:`composite_key` enforces.  If ``capacity`` is None the exact
    cardinality is computed first (two-phase execution, the eager ETL path,
    one host round-trip per join); pass a static ``capacity`` to skip it,
    or use the compiled pipeline (:mod:`repro_torch.core.pipeline`) which
    pre-sizes capacities from the cost model and retries on overflow.
    """
    on = tuple((l, r) for l, r in on)
    if capacity is None:
        on_left = (on[0][0],)
        on_right = (on[0][1],)
        n = int(join_count(left, right, on_left, on_right))
        if how == "left_outer":
            n += int(left.num_rows())  # upper bound incl. unmatched rows
        capacity = _round_capacity(n)
    return join_with_capacity(left, right, on, how, capacity=capacity,
                              indicator=indicator)[0]


def left_outer_join(
    left: Table,
    right: Table,
    on: Sequence[Tuple[str, str]],
    indicator: str,
    capacity: Optional[int] = None,
) -> Table:
    """Exact left-outer join for any number of equality conditions.

    The eager two-phase wrapper over :func:`left_outer_with_capacity` (one
    implementation of the Thm 4.3 invariant — exactly one null row per
    unmatched left row): ``capacity=None`` counts the first-key expansion
    first, exactly like :func:`sort_merge_join`.  With several conditions
    ``capacity`` sizes the inner expansion only; the appended unmatched
    rows are bounded by ``left.capacity`` statically.
    """
    on = tuple((l, r) for l, r in on)
    if capacity is None:
        n = int(join_count(left, right, (on[0][0],), (on[0][1],)))
        if len(on) == 1:
            n += int(left.num_rows())  # native outer path holds null rows too
        capacity = _round_capacity(n)
    return left_outer_with_capacity(left, right, on, indicator, capacity)[0]


def semi_join_mask(
    left: Table, right: Table, on: Sequence[Tuple[str, str]]
) -> torch.Tensor:
    """Boolean mask over left rows with >=1 match in right (for pruning).

    Approximate (never false-negative) when more than one condition is given:
    only the first condition is checked.
    """
    on = list(on)[:1]
    lk = composite_key(left, tuple(l for l, _ in on))
    rk = composite_key(right, tuple(r for _, r in on))
    rk_sorted = torch.sort(rk).values
    lo = torch.searchsorted(rk_sorted, lk, out_int32=True)
    hi = torch.searchsorted(rk_sorted, lk, right=True, out_int32=True)
    return left.valid & (lk != int(NULL_KEY64)) & (hi > lo)
