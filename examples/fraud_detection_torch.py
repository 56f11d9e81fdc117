"""Fraud-detection scenario end to end: extract the Sell/Buy graph
(Figure 11(b)), then run graph analytics (degree outliers + PageRank) to
flag customers who buy many products from a single store — the paper's
motivating use case for graph extraction.  The port (``repro_torch``) of
``examples/fraud_detection.py``, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/fraud_detection_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                             # noqa: E402

from repro_torch.core import extract_graph                     # noqa: E402
from repro_torch.data import fraud_model, make_tpcds           # noqa: E402
from repro_torch.graph import build_csr, pagerank              # noqa: E402
from repro_torch.relational.table import host                  # noqa: E402


def main(device=None):
    db = make_tpcds(sf=3, seed=0, device=device)
    model = fraud_model("store")

    graph, t = extract_graph(db, model, method="extgraph", verbose=True)
    print(f"extracted in {t.total_s:.2f}s "
          f"(plan {t.plan_s:.2f}s, exec {t.extract_s:.2f}s)")

    csr = build_csr(graph, model)
    print(f"graph: {csr.num_vertices} vertices, {csr.edge_counts}")

    # customers with outlier Buy degree (bulk buyers)
    lo, hi = csr.vertex_ranges["Customer"]
    buy_deg = host(csr.out_degree("Buy"))[lo:hi]
    mean, std = buy_deg.mean(), buy_deg.std()
    flags = np.where(buy_deg > mean + 4 * std)[0]
    print(f"degree outliers (>4 sigma): {len(flags)} customers")
    for f in flags[:5]:
        print(f"   customer id={int(host(csr.vertex_ids)[lo + f])} "
              f"bought {int(buy_deg[f])} items (mean {mean:.1f})")

    # PageRank over Buy edges concentrates mass on hot items
    pr = host(pagerank(csr, "Buy", iters=15))
    ilo, ihi = csr.vertex_ranges["Item"]
    top_items = np.argsort(pr[ilo:ihi])[::-1][:5]
    print("hottest items by PageRank:",
          [int(host(csr.vertex_ids)[ilo + i]) for i in top_items])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; default: the CUDA card")
    main(device=ap.parse_args().device)
