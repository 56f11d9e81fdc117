"""Synthetic DBLP-shaped dataset + the Figure 12 graph model.

Schema: author(rid, a_id), paper(rid, p_id, v_sk), venue(rid, v_id),
editor(rid, e_id), wrote(rid, a_sk, p_sk), edits(rid, e_sk, v_sk).

Edges: Co-auth  = A1 |><| W1 |><| P |><| W2 |><| A2      (chain, palindromic)
       Auth-Edit = A |><| W |><| P |><| V |><| ED |><| E  (chain)
Shared structure: A |><| W |><| P appears three times across the two queries
— the JS-MV sweet spot the paper reports for DBLP.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.builder import join_query
from repro_torch.core.database import Database
from repro_torch.core.model import GraphModel, JoinQuery
from repro_torch.relational import Table, resolve_device


def make_dblp(scale: int = 1, seed: int = 1, device=None) -> Database:
    """``device=None`` places the tables on the CUDA card (raises without one)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_auth = 4000 * scale
    n_paper = 6000 * scale
    n_venue = max(32, 40 * scale)
    n_editor = max(32, 200 * scale)
    n_wrote = 18000 * scale          # ~3 authors/paper
    n_edits = max(64, 400 * scale)   # editors per venue

    db = Database()
    db.add_table("author", Table.from_arrays(
        device=dev,
        rid=np.arange(n_auth, dtype=np.int32),
        a_id=np.arange(n_auth, dtype=np.int32),
        a_prop=rng.integers(0, 100, n_auth).astype(np.int32)))
    db.add_table("paper", Table.from_arrays(
        device=dev,
        rid=np.arange(n_paper, dtype=np.int32),
        p_id=np.arange(n_paper, dtype=np.int32),
        v_sk=rng.integers(0, n_venue, n_paper).astype(np.int32)))
    db.add_table("venue", Table.from_arrays(
        device=dev,
        rid=np.arange(n_venue, dtype=np.int32),
        v_id=np.arange(n_venue, dtype=np.int32)))
    db.add_table("editor", Table.from_arrays(
        device=dev,
        rid=np.arange(n_editor, dtype=np.int32),
        e_id=np.arange(n_editor, dtype=np.int32)))
    db.add_table("wrote", Table.from_arrays(
        device=dev,
        rid=np.arange(n_wrote, dtype=np.int32),
        a_sk=rng.integers(0, n_auth, n_wrote).astype(np.int32),
        p_sk=rng.integers(0, n_paper, n_wrote).astype(np.int32)))
    db.add_table("edits", Table.from_arrays(
        device=dev,
        rid=np.arange(n_edits, dtype=np.int32),
        e_sk=rng.integers(0, n_editor, n_edits).astype(np.int32),
        v_sk=rng.integers(0, n_venue, n_edits).astype(np.int32)))
    return db


def coauth_query() -> JoinQuery:
    return join_query(
        "Co-auth",
        relations=[("A1", "author"), ("W1", "wrote"), ("P", "paper"),
                   ("W2", "wrote"), ("A2", "author")],
        joins=["A1.a_id == W1.a_sk", "W1.p_sk == P.p_id",
               "P.p_id == W2.p_sk", "W2.a_sk == A2.a_id"],
        src="A1.a_id", dst="A2.a_id")


def authedit_query() -> JoinQuery:
    return join_query(
        "Auth-Edit",
        relations=[("A", "author"), ("W", "wrote"), ("P", "paper"),
                   ("V", "venue"), ("ED", "edits"), ("E", "editor")],
        joins=["A.a_id == W.a_sk", "W.p_sk == P.p_id", "P.v_sk == V.v_id",
               "V.v_id == ED.v_sk", "ED.e_sk == E.e_id"],
        src="A.a_id", dst="E.e_id")


def dblp_model() -> GraphModel:
    return (GraphModel.builder("dblp")
            .vertex("Author", table="author", id_col="a_id",
                    props=("a_prop",))
            .vertex("Editor", table="editor", id_col="e_id")
            .edge("Co-auth", src="Author", dst="Author",
                  query=coauth_query())
            .edge("Auth-Edit", src="Author", dst="Editor",
                  query=authedit_query())
            .build())
