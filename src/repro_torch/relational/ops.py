"""Non-join relational operators: filter, project, dedup, compact, concat."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.relational.join import composite_key
from repro_torch.relational.table import Table, host

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def filter_table(table: Table, col: str, op: str, value) -> Table:
    """sigma_{col op value}(table); mask-only, shape preserved."""
    return table.mask(_OPS[op](table[col], value))


def project(table: Table, names: Sequence[str]) -> Table:
    return table.select(list(names))


def compact(table: Table, capacity: Optional[int] = None) -> Table:
    """Stable-move valid rows to the front (prefix layout).

    Needed before slicing a table down to a smaller capacity.
    """
    cap = capacity or table.capacity
    # stable argsort of (not valid) keeps relative order of valid rows
    order = torch.argsort((~table.valid).to(torch.uint8), stable=True)
    order = order[:cap]
    cols = {k: v[order] for k, v in table.columns.items()}
    valid = table.valid[order]
    return Table(columns=cols, valid=valid)


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` order: the last key is primary; ties keep input order.

    Chained stable argsorts from the minor key to the major key.
    """
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        kk = k[order]
        if kk.dtype == torch.bool:
            kk = kk.to(torch.uint8)
        order = order[torch.argsort(kk, stable=True)]
    return order


def dedup(table: Table, keys: Sequence[str]) -> Table:
    """Keep one valid row per distinct key tuple (any number of key columns).

    Lexicographic sort (invalid rows last) + neighbour comparison; rows come
    back key-sorted with duplicates masked out.  No 64-bit packing needed.
    """
    keys = list(keys)
    # lexsort: last key is the primary -> order (minor..major)
    sort_keys = [table[k] for k in reversed(keys)] + [~table.valid]
    order = _lexsort(sort_keys)
    sorted_valid = table.valid[order]
    dev = table.device
    false = torch.zeros((1,), dtype=torch.bool, device=dev)
    same = torch.ones(table.capacity, dtype=torch.bool, device=dev)
    for k in keys:
        col = table[k][order]
        eq = torch.cat([false, col[1:] == col[:-1]])
        same = same & eq
    prev_valid = torch.cat([false, sorted_valid[:-1]])
    first = ~(same & prev_valid)
    cols = {name: col[order] for name, col in table.columns.items()}
    return Table(columns=cols, valid=sorted_valid & first)


def concat(tables: Sequence[Table]) -> Table:
    names = tables[0].column_names()
    for t in tables[1:]:
        if t.column_names() != names:
            raise ValueError("concat requires identical schemas")
    cols = {
        n: torch.cat([t[n] for t in tables]) for n in names
    }
    valid = torch.cat([t.valid for t in tables])
    return Table(columns=cols, valid=valid)


def bag_cancel_mask(
    main_cols: Sequence[np.ndarray],
    main_valid: np.ndarray,
    minus_cols: Sequence[np.ndarray],
    minus_valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Keep-mask over main rows after bag-cancelling ``minus`` rows.

    Multiset difference on the key tuple formed by the given columns: a
    minus row with multiplicity ``m`` invalidates exactly ``m`` matching
    valid main rows (the first ``m`` in a canonical sort — which ones is
    immaterial under bag semantics).  Host-side numpy: one lexsort of the
    combined rows; no compile, no device sync.  Invalid main rows stay
    invalid; minus rows with no match cancel nothing.
    """
    main_cols = [np.asarray(c) for c in main_cols]
    minus_cols = [np.asarray(c) for c in minus_cols]
    main_valid = np.asarray(main_valid, dtype=bool)
    n = main_valid.shape[0]
    if minus_valid is None:
        minus_valid = np.ones(minus_cols[0].shape, dtype=bool) \
            if minus_cols else np.zeros((0,), dtype=bool)
    minus_valid = np.asarray(minus_valid, dtype=bool)
    m = minus_valid.shape[0]
    if m == 0 or not minus_valid.any():
        return main_valid.copy()

    # Prefilter: only main rows sharing the first key value with some minus
    # row can cancel.  Minus sides are tiny relative to maintained tables
    # (that is the point of incremental maintenance), so this turns an
    # O(n log n) lexsort over the whole table into one binary search plus a
    # lexsort over the few candidate rows.
    uniq = np.unique(minus_cols[0][minus_valid])
    pos = np.searchsorted(uniq, main_cols[0])
    pos_c = np.minimum(pos, len(uniq) - 1)
    cand = main_valid & (uniq[pos_c] == main_cols[0])
    if not cand.any():
        return main_valid.copy()
    if cand.sum() < n:
        idx = np.flatnonzero(cand)
        sub_keep = bag_cancel_mask(
            [c[idx] for c in main_cols], np.ones(len(idx), dtype=bool),
            minus_cols, minus_valid)
        keep = main_valid.copy()
        keep[idx] = sub_keep
        return keep

    cols = [np.concatenate([a, b]) for a, b in zip(main_cols, minus_cols)]
    is_main = np.concatenate(
        [np.ones(n, dtype=np.int8), np.zeros(m, dtype=np.int8)])
    valid = np.concatenate([main_valid, minus_valid])
    # priority: valid rows first, then key columns, then minus before main
    order = np.lexsort((is_main,) + tuple(reversed(cols)) + (~valid,))
    idx = np.arange(n + m)
    s_main = is_main[order].astype(bool)
    s_valid = valid[order]
    same = np.ones(n + m, dtype=bool)
    for c in cols:
        sc = c[order]
        same[1:] &= sc[1:] == sc[:-1]
    same[0] = False
    new_group = ~same
    group_start = np.maximum.accumulate(np.where(new_group, idx, -1))
    prev_main = np.concatenate([[False], s_main[:-1]])
    first_main = s_main & (new_group | ~prev_main)
    fm_pos = np.maximum.accumulate(np.where(first_main, idx, -1))
    # main row at sorted pos p: its group holds (fm - start) minus rows,
    # all sorted ahead of the mains; cancel the first that many mains
    num_minus = fm_pos - group_start
    cancel = s_main & s_valid & ((idx - fm_pos) < num_minus)
    keep_sorted = ~cancel
    keep = np.empty(n + m, dtype=bool)
    keep[order] = keep_sorted
    return main_valid & keep[:n]


def subtract_bag(table: Table, minus: Table,
                 keys: Optional[Sequence[str]] = None) -> Table:
    """Bag difference ``table ∖ minus`` over ``keys`` (default: all of
    ``minus``'s columns).  Each valid minus row invalidates one matching
    valid row; shape is preserved (mask-only, like :func:`filter_table`).
    """
    if keys is None:
        keys = minus.column_names()
    keep = bag_cancel_mask(
        [host(table[k]) for k in keys],
        host(table.valid),
        [host(minus[k]) for k in keys],
        host(minus.valid),
    )
    return table.mask(torch.from_numpy(keep).to(table.device))


def count_distinct(table: Table, col: str) -> int:
    """Host-side distinct count of a key column (ANALYZE-style statistic)."""
    vals = host(table[col][table.valid])
    return int(np.unique(vals).size)


def table_digest(table: Table) -> str:
    """Content address of the *valid* rows (column names + values).

    Rows are canonicalized by a lexicographic sort first, so the digest is
    a *bag* address: padding, capacity, and row order — which vary with the
    plan that produced the table — never change it.  Used to
    content-address derived artifacts.  Equal to the JAX package's digest of
    the same bag, column dtypes included.
    """
    import hashlib

    h = hashlib.sha1()
    data = table.to_numpy()
    names = sorted(data)
    n = len(data[names[0]]) if names else 0
    if n:
        order = np.lexsort(tuple(data[k] for k in reversed(names)))
    else:
        order = np.arange(0)
    for name in names:
        h.update(name.encode())
        h.update(np.ascontiguousarray(data[name][order]).tobytes())
    return h.hexdigest()[:16]
