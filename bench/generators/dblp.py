"""DBLP-shaped tables as host arrays: a frozen copy of ``make_dblp``'s draws.

The same ``numpy`` stream as ``repro_torch.data.dblp.make_dblp(scale,
seed)``: authors, papers (each at a uniform venue), venues, editors,
``wrote`` (uniform author and paper: about 3 authors a paper) and
``edits`` (uniform editor and venue).  Only the row counts follow the
dblp dump; the uniform keys and the venue-editor relation are this
generator's own (see ``configs/dblp.json``, ``assumed``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def generate(params: Dict, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """{table: {column: int32 array}} for ``params["scale"]`` (a whole
    number as in ``make_dblp``; a fraction gives the tests' smaller
    tables)."""
    scale = params["scale"]
    rng = np.random.default_rng(seed)
    n_auth = int(4000 * scale)
    n_paper = int(6000 * scale)
    n_venue = max(32, int(40 * scale))
    n_editor = max(32, int(200 * scale))
    n_wrote = int(18000 * scale)
    n_edits = max(64, int(400 * scale))

    def ids(n):
        return np.arange(n, dtype=np.int32)

    tables = {}
    tables["author"] = {"rid": ids(n_auth), "a_id": ids(n_auth),
                        "a_prop": rng.integers(0, 100, n_auth)
                        .astype(np.int32)}
    tables["paper"] = {"rid": ids(n_paper), "p_id": ids(n_paper),
                       "v_sk": rng.integers(0, n_venue, n_paper)
                       .astype(np.int32)}
    tables["venue"] = {"rid": ids(n_venue), "v_id": ids(n_venue)}
    tables["editor"] = {"rid": ids(n_editor), "e_id": ids(n_editor)}
    tables["wrote"] = {"rid": ids(n_wrote),
                       "a_sk": rng.integers(0, n_auth, n_wrote)
                       .astype(np.int32),
                       "p_sk": rng.integers(0, n_paper, n_wrote)
                       .astype(np.int32)}
    tables["edits"] = {"rid": ids(n_edits),
                       "e_sk": rng.integers(0, n_editor, n_edits)
                       .astype(np.int32),
                       "v_sk": rng.integers(0, n_venue, n_edits)
                       .astype(np.int32)}
    return tables
