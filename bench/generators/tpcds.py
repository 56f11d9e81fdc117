"""TPC-DS sales channels as host arrays, drawn as ``dsdgen`` draws them.

Row counts are the specification's (TPC-DS v3, Table 3-2) at the scale
factor asked for.  The fact tables are drawn as ``dsdgen`` draws a
ticket (store) or an order (catalog, web): a uniform number of line
items in the channel's range, one customer and one outlet a ticket, each
picked uniformly among the dimension's rows, items taken one after the
other from a seeded permutation of the items from a uniform start (so no
item repeats within a ticket), and a uniform promotion a line.  The last
ticket is cut so that each fact table has the specification's row count.
``dsdgen``'s NULL foreign keys are not drawn: every sale joins.

Only the key columns that the graph models read are made, with ``rid``
and one property column a dimension; all are int32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# TPC-DS specification v3, Table 3-2: rows by scale factor
SPEC_ROWS = {
    1: {"customer": 100_000, "item": 18_000, "promotion": 300,
        "store": 12, "call_center": 6, "web_site": 30,
        "store_sales": 2_880_404, "catalog_sales": 1_441_548,
        "web_sales": 719_384},
    10: {"customer": 500_000, "item": 102_000, "promotion": 500,
         "store": 102, "call_center": 24, "web_site": 42,
         "store_sales": 28_800_991, "catalog_sales": 14_401_261,
         "web_sales": 7_197_566},
}
# channel: (fact table, outlet table, line items a ticket or order)
CHANNELS = {"store": ("store_sales", "store", (8, 16)),
            "catalog": ("catalog_sales", "call_center", (4, 14)),
            "web": ("web_sales", "web_site", (8, 16))}
DIMENSIONS = {"customer": ("c_id", "c_prop"), "item": ("i_id", "i_price"),
              "promotion": ("p_id", "p_prop")}


def row_counts(params: Dict) -> Dict[str, int]:
    """The rows of every table: the specification's at
    ``params["scale_factor"]``, times ``params["fraction"]`` (default 1;
    the tests' smaller tables, at least 2 rows a table)."""
    rows = SPEC_ROWS[int(params["scale_factor"])]
    frac = float(params.get("fraction", 1))
    return {t: n if frac == 1 else max(2, round(n * frac))
            for t, n in rows.items()}


def _dim(rng, n: int, id_name: str, prop_name: str) -> Dict[str, np.ndarray]:
    return {"rid": np.arange(n, dtype=np.int32),
            id_name: np.arange(n, dtype=np.int32),
            prop_name: rng.integers(0, 1000, n).astype(np.int32)}


def _fact(rng, n_rows: int, lines: Tuple[int, int], n_cust: int,
          item_perm: np.ndarray, n_promo: int, n_outlet: int
          ) -> Dict[str, np.ndarray]:
    lo, hi = lines
    sizes = rng.integers(lo, hi + 1, n_rows // lo + 1)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, n_rows)) + 1       # tickets needed
    sizes, ends = sizes[:k], ends[:k]
    sizes[-1] -= int(ends[-1]) - n_rows               # cut the last one
    ends[-1] = n_rows
    ticket = np.repeat(np.arange(k), sizes)
    line = np.arange(n_rows) - (ends - sizes)[ticket]
    n_item = item_perm.shape[0]
    start = rng.integers(0, n_item, k)
    return {
        "rid": np.arange(n_rows, dtype=np.int32),
        "c_sk": rng.integers(0, n_cust, k).astype(np.int32)[ticket],
        "i_sk": item_perm[(start[ticket] + line) % n_item],
        "p_sk": rng.integers(0, n_promo, n_rows).astype(np.int32),
        "o_sk": rng.integers(0, n_outlet, k).astype(np.int32)[ticket],
    }


def generate(params: Dict, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """{table: {column: int32 array}}: the dimensions, then each
    channel's outlet and fact table in the order store, catalog, web."""
    rows = row_counts(params)
    rng = np.random.default_rng(seed)
    tables = {t: _dim(rng, rows[t], *cols) for t, cols in DIMENSIONS.items()}
    item_perm = rng.permutation(rows["item"]).astype(np.int32)
    for fact, outlet, lines in CHANNELS.values():
        tables[outlet] = _dim(rng, rows[outlet], "o_id", "o_prop")
        tables[fact] = _fact(rng, rows[fact], lines, rows["customer"],
                             item_perm, rows["promotion"], rows[outlet])
    return tables
