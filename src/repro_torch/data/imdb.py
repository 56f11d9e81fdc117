"""Synthetic IMDB-shaped dataset + the Figure 13 graph model.

Schema: person(rid, per_id), movie(rid, m_id), and per-role cast tables
acts / directs / writes (rid, per_sk, m_sk).

Edges: Wri-Dir = PW |><| WR |><| M |><| DI |><| PD
       Act-Dir = PA |><| AC |><| M |><| DI |><| PD
Shared structure: M |><| DI |><| PD (the director half) appears in both —
the JS-OJ / JS-MV candidate for this dataset.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.builder import join_query
from repro_torch.core.database import Database
from repro_torch.core.model import GraphModel, JoinQuery
from repro_torch.relational import Table, resolve_device


def make_imdb(scale: int = 1, seed: int = 2, device=None) -> Database:
    """``device=None`` places the tables on the CUDA card (raises without one)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_person = 8000 * scale
    n_movie = 3000 * scale
    n_acts = 24000 * scale
    n_directs = 3500 * scale
    n_writes = 5000 * scale

    db = Database()
    db.add_table("person", Table.from_arrays(
        device=dev,
        rid=np.arange(n_person, dtype=np.int32),
        per_id=np.arange(n_person, dtype=np.int32),
        per_prop=rng.integers(0, 100, n_person).astype(np.int32)))
    db.add_table("movie", Table.from_arrays(
        device=dev,
        rid=np.arange(n_movie, dtype=np.int32),
        m_id=np.arange(n_movie, dtype=np.int32),
        m_year=rng.integers(1950, 2024, n_movie).astype(np.int32)))
    for name, n in (("acts", n_acts), ("directs", n_directs),
                    ("writes", n_writes)):
        db.add_table(name, Table.from_arrays(
            device=dev,
            rid=np.arange(n, dtype=np.int32),
            per_sk=rng.integers(0, n_person, n).astype(np.int32),
            m_sk=rng.integers(0, n_movie, n).astype(np.int32)))
    return db


def _role_pair_query(name: str, role_l: str, role_r: str) -> JoinQuery:
    return join_query(
        name,
        relations=[("PL", "person"), ("RL", role_l), ("M", "movie"),
                   ("RR", role_r), ("PR", "person")],
        joins=["PL.per_id == RL.per_sk", "RL.m_sk == M.m_id",
               "M.m_id == RR.m_sk", "RR.per_sk == PR.per_id"],
        src="PL.per_id", dst="PR.per_id")


def wridir_query() -> JoinQuery:
    return _role_pair_query("Wri-Dir", "writes", "directs")


def actdir_query() -> JoinQuery:
    return _role_pair_query("Act-Dir", "acts", "directs")


def imdb_model() -> GraphModel:
    return (GraphModel.builder("imdb")
            .vertex("Person", table="person", id_col="per_id",
                    props=("per_prop",))
            .vertex("Movie", table="movie", id_col="m_id",
                    props=("m_year",))
            .edge("Wri-Dir", src="Person", dst="Person",
                  query=wridir_query())
            .edge("Act-Dir", src="Person", dst="Person",
                  query=actdir_query())
            .build())
