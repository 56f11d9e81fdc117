"""The client: one graph pipeline job, closed loop, one request at a time.

A request is timed on the host's clock from the call that starts it
(with ``engine: per_request``, the new ``ExtractionEngine``) to the
return of ``extract(model)``, which ends in a device sync.  What the job
then does with the graph (count its edges; for the sampled request, copy
it to the host for the check) is outside the request's time but inside
the window's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from harness import check


class Client:
    def __init__(self, db, model, model_spec: Dict, traffic: Dict):
        from repro_torch import obs
        from repro_torch.api import ExtractionEngine
        from repro_torch.kernels import ops as kops

        self.db, self.model, self.spec = db, model, model_spec
        self.obs, self.kops, self.Engine = obs, kops, ExtractionEngine
        self.per_request = traffic["engine"] == "per_request"
        if traffic["engine"] not in ("per_request", "shared"):
            raise ValueError(f"traffic engine {traffic['engine']!r}")
        self.engine = None if self.per_request else ExtractionEngine(db)
        self.labels = [e["label"] for e in model_spec["edges"]]
        self.last_graph = None

    def request(self, keep_spans: bool = False) -> Dict:
        """One request; its record (``failed`` when it raised), with the
        program's spans when ``keep_spans``."""
        retries0 = 0 if self.per_request else \
            self.engine.compiler.stats["retries"]
        launches0 = self.kops.launch_counts()
        self.last_graph = None           # the job handed the last one on
        try:
            with self.obs.span("bench.request") as root:
                t0 = time.perf_counter()
                engine = self.Engine(self.db) if self.per_request \
                    else self.engine
                res = engine.extract(self.model)
                t1 = time.perf_counter()
        except Exception as exc:                      # counted, not fatal
            return {"failed": True, "error": repr(exc)[:300]}
        spans = self.obs.TRACER.get(root.trace_id) or []
        vertices_s = next((s["dur_s"] for s in spans
                           if s["name"] == "vertices"), None)
        launches = self.kops.launch_counts()
        rec = {
            "failed": False, "start": t0, "end": t1, "latency_s": t1 - t0,
            "plan_s": res.timings.plan_s, "extract_s": res.timings.extract_s,
            "vertices_s": vertices_s,
            "retries": engine.compiler.stats["retries"] - retries0,
            "launches": {k: launches[k] - launches0.get(k, 0)
                         for k in launches},
            "plan_cache_hit": res.provenance.plan_cache_hit,
            "views_built": list(res.provenance.views_built),
            "views_reused": list(res.provenance.views_reused),
            "edges_by_label": {k: int(res.graph.edges[k].valid.sum())
                               for k in self.labels},
        }
        if keep_spans:
            rec["spans"] = spans
        rec["edges"] = sum(rec["edges_by_label"].values())
        self.last_graph = res.graph
        return rec

    def host_copy(self):
        """The last graph's edge and vertex rows, copied to the host."""
        g = self.last_graph
        return (check.program_edges(g, self.labels, "cpu"),
                check.program_vertices(g, self.spec, "cpu"))

    def close(self):
        self.engine = self.db = self.last_graph = None


def window(client: Client, seconds: float, sample: int
           ) -> Tuple[List[Dict], Optional[tuple], float, float]:
    """Requests back to back for ``seconds``; returns (records, the host
    copy of request ``sample``, the seconds that copy took, the window's
    length).  The copy is the check's work, not the workload's: the
    window's clock stops while it runs."""
    records, kept, copy_s = [], None, 0.0
    start = time.perf_counter()
    while time.perf_counter() - copy_s < start + seconds:
        rec = client.request()
        records.append(rec)
        if len(records) - 1 == sample and not rec["failed"]:
            t = time.perf_counter()
            kept = client.host_copy()
            copy_s = time.perf_counter() - t
    return records, kept, copy_s, time.perf_counter() - start - copy_s
