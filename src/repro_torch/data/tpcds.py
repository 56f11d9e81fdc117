"""Synthetic TPC-DS subset: the tables the paper's graph models touch.

Real TPC-DS at SF=10 has ~28.8M store_sales rows; the generator keeps the
paper's *ratios* and scales absolute row counts down by 1000x ("SF 10"
here = 28.8k fact rows, so ``sf=1000`` is TPC-DS SF1's 2.88M).  Skew follows TPC-DS: fact foreign keys
are drawn from a truncated Zipf so hot items/customers exist.

Tables (per sales channel c in {store, catalog, web}):
  customer(rid, c_id, c_prop)            dimension
  item(rid, i_id, i_price)               dimension
  promotion(rid, p_id, p_prop)           dimension
  outlet_<c>(rid, o_id, o_prop)          store / catalog_page / web_site
  <c>_sales(rid, c_sk, i_sk, p_sk, o_sk) fact

Graph models (Figure 11):
  recommendation: Buy = C|><|F|><|I, Co-pur = C1|><|F1|><|I|><|F2|><|C2,
                  Same-pro = C1|><|F1|><|P|><|F2|><|C2
  fraud:          Sell = O|><|F|><|I, Buy = C|><|F|><|I
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.api.builder import join_query
from repro_torch.core.database import Database
from repro_torch.core.model import GraphModel, JoinQuery
from repro_torch.relational import Table, resolve_device

CHANNELS = ("store", "catalog", "web")


def _zipf_choice(rng, n: int, size: int, a: float = 1.2) -> np.ndarray:
    """Zipf-skewed ids in [0, n) (truncated, reshuffled for anonymity)."""
    ranks = rng.zipf(a, size=size)
    ranks = np.minimum(ranks - 1, n - 1)
    perm = rng.permutation(n)
    return perm[ranks].astype(np.int32)


def _dim(rng, n: int, id_name: str, prop_name: str, dev) -> Table:
    return Table.from_arrays(
        device=dev,
        rid=np.arange(n, dtype=np.int32),
        **{id_name: np.arange(n, dtype=np.int32)},
        **{prop_name: rng.integers(0, 1000, n).astype(np.int32)},
    )


def make_tpcds(sf: int = 10, seed: int = 0, device=None) -> Database:
    """All three channels at the given (down-scaled) scale factor.

    ``device=None`` places the tables on the CUDA card (raises without one).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_cust = max(64, 500 * sf)
    n_item = max(64, 100 * sf)
    n_promo = max(16, 4 * sf)
    db = Database()
    db.add_table("customer", _dim(rng, n_cust, "c_id", "c_prop", dev))
    db.add_table("item", _dim(rng, n_item, "i_id", "i_price", dev))
    db.add_table("promotion", _dim(rng, n_promo, "p_id", "p_prop", dev))
    for ch, fact_scale, n_outlet in (
        ("store", 2880, max(4, sf // 2 + 2)),
        ("catalog", 1440, max(4, sf // 3 + 2)),
        ("web", 720, max(4, sf // 3 + 2)),
    ):
        n_fact = fact_scale * sf
        db.add_table(f"outlet_{ch}",
                     _dim(rng, n_outlet, "o_id", "o_prop", dev))
        db.add_table(
            f"{ch}_sales",
            Table.from_arrays(
                device=dev,
                rid=np.arange(n_fact, dtype=np.int32),
                c_sk=_zipf_choice(rng, n_cust, n_fact),
                i_sk=_zipf_choice(rng, n_item, n_fact),
                p_sk=rng.integers(0, n_promo, n_fact).astype(np.int32),
                o_sk=rng.integers(0, n_outlet, n_fact).astype(np.int32),
            ),
        )
    return db


def buy_query(ch: str, name: str = "Buy") -> JoinQuery:
    f = f"{ch}_sales"
    return join_query(
        name,
        relations=[("C", "customer"), ("F", f), ("I", "item")],
        joins=["C.c_id == F.c_sk", "F.i_sk == I.i_id"],
        src="C.c_id", dst="I.i_id")


def sell_query(ch: str, name: str = "Sell") -> JoinQuery:
    f = f"{ch}_sales"
    return join_query(
        name,
        relations=[("O", f"outlet_{ch}"), ("F", f), ("I", "item")],
        joins=["O.o_id == F.o_sk", "F.i_sk == I.i_id"],
        src="O.o_id", dst="I.i_id")


def copur_query(ch: str, name: str = "Co-pur") -> JoinQuery:
    f = f"{ch}_sales"
    return join_query(
        name,
        relations=[("C1", "customer"), ("F1", f), ("I", "item"),
                   ("F2", f), ("C2", "customer")],
        joins=["C1.c_id == F1.c_sk", "F1.i_sk == I.i_id",
               "I.i_id == F2.i_sk", "F2.c_sk == C2.c_id"],
        src="C1.c_id", dst="C2.c_id")


def samepro_query(ch: str, name: str = "Same-pro") -> JoinQuery:
    f = f"{ch}_sales"
    return join_query(
        name,
        relations=[("C1", "customer"), ("F1", f), ("P", "promotion"),
                   ("F2", f), ("C2", "customer")],
        joins=["C1.c_id == F1.c_sk", "F1.p_sk == P.p_id",
               "P.p_id == F2.p_sk", "F2.c_sk == C2.c_id"],
        src="C1.c_id", dst="C2.c_id")


def _base_builder(name: str):
    return (GraphModel.builder(name)
            .vertex("Customer", table="customer", id_col="c_id",
                    props=("c_prop",))
            .vertex("Item", table="item", id_col="i_id",
                    props=("i_price",)))


def recommendation_model(ch: str) -> GraphModel:
    """Figure 11(a): Buy + Co-pur + Same-pro for one channel."""
    return (_base_builder(f"recommendation_{ch}")
            .vertex("Promotion", table="promotion", id_col="p_id")
            .edge("Buy", src="Customer", dst="Item", query=buy_query(ch))
            .edge("Co-pur", src="Customer", dst="Customer",
                  query=copur_query(ch))
            .edge("Same-pro", src="Customer", dst="Customer",
                  query=samepro_query(ch))
            .build())


def fraud_model(ch: str) -> GraphModel:
    """Figure 11(b): Sell + Buy for one channel."""
    return (_base_builder(f"fraud_{ch}")
            .vertex("Outlet", table=f"outlet_{ch}", id_col="o_id")
            .edge("Sell", src="Outlet", dst="Item", query=sell_query(ch))
            .edge("Buy", src="Customer", dst="Item", query=buy_query(ch))
            .build())


def combined_model(rec_ch: str = "catalog", fraud_ch: str = "store") -> GraphModel:
    """Figure 16(a): recommendation(catalog) + fraud(store), 4 queries."""
    return (_base_builder("combined")
            .vertex("Outlet", table=f"outlet_{fraud_ch}", id_col="o_id")
            .vertex("Promotion", table="promotion", id_col="p_id")
            .edge("Sell", src="Outlet", dst="Item", query=sell_query(fraud_ch))
            .edge("Buy", src="Customer", dst="Item", query=buy_query(fraud_ch))
            .edge("Co-pur", src="Customer", dst="Customer",
                  query=copur_query(rec_ch))
            .edge("Same-pro", src="Customer", dst="Customer",
                  query=samepro_query(rec_ch))
            .build())


def getdisc_query(ch: str = "store", name: str = "Get-disc") -> JoinQuery:
    """The cyclic query of Listing 1 (star/cyclic support demo)."""
    f = f"{ch}_sales"
    return join_query(
        name,
        relations=[("C", "customer"), ("F", f), ("P", "promotion"),
                   ("I", "item")],
        joins=["C.c_id == F.c_sk", "F.i_sk == I.i_id",
               "F.p_sk == P.p_id",
               "P.p_prop == I.i_price"],   # cyclic closure
        src="C.c_id", dst="I.i_id")
