from repro_torch.data.tpcds import (
    make_tpcds,
    recommendation_model,
    fraud_model,
    combined_model,
    getdisc_query,
)
from repro_torch.data.dblp import make_dblp, dblp_model
from repro_torch.data.imdb import make_imdb, imdb_model

__all__ = [
    "make_tpcds",
    "recommendation_model",
    "fraud_model",
    "combined_model",
    "getdisc_query",
    "make_dblp",
    "dblp_model",
    "make_imdb",
    "imdb_model",
]
