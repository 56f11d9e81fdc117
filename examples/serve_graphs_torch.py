"""HTTP front end for the PyTorch port's multi-tenant graph service.

The counterpart of ``examples/serve_graphs.py`` (same endpoints, error
bodies and status mapping) over :class:`repro_torch.serving.GraphService`.
Shaped like an api-gateway routing into a graph-extraction service: a
``ThreadingHTTPServer`` whose handlers are thin — admission, coalescing,
MVCC, and quotas all live in the service; this file only translates HTTP.
The data and the engine live on ``--device`` (default: the CUDA card,
which it needs unless ``--device cpu`` is given).

Endpoints (tenant comes from the ``X-Tenant`` header, default "public"):

    GET  /healthz                     liveness + served epoch
    GET  /v1/stats                    snapshots/scheduler/tenants/engine
    GET  /v1/metrics                  metrics registry (JSON; add
                                      ?format=prometheus for text format)
    GET  /v1/trace/<id>               one request's span tree + summary
                                      (?format=chrome for Perfetto /
                                      chrome://tracing events, served as
                                      an application/json attachment)
    GET  /v1/traces                   recent trace digests: id, root span
                                      + category, wall time (?limit=N)
    GET  /v1/models                   registered model names
    POST /v1/extract    {"model": name | spec, "method"?, "epoch"?}
    POST /v1/explain    {"model": name | spec, "method"?, "analyze"?,
                         "epoch"?}  EXPLAIN (ANALYZE) plan report
    POST /v1/analyze    {"model": name, "algorithm"?, "params"?, "epoch"?}
    POST /v1/discover   {"tables"?: [...], "sample"?, "use_name_hints"?,
                         "accept_threshold"?, "top"?, "epoch"?}
    POST /v1/mutate     {"table": name, "insert"?: {col: [...]},
                         "delete_where"?: [col, op, value]}
    POST /v1/refresh    {}            build + publish the next epoch

Error hygiene: every non-2xx body is the same JSON shape —
``{"error": str, "retryable": bool, "trace_id": str, "retry_after"?: s}``
— so a client can branch on ``retryable`` without parsing prose.  The
mapping: full queue / over-quota → ``429`` (+ ``Retry-After``), retired
epoch → ``410``, unknown model → ``404``, bad request → ``400``, blown
deadline → ``504``, transient internal failure → ``503`` (retryable),
shutdown / anything else → ``503`` / ``500``.

Durability: ``--durable-dir DIR`` WALs every mutation and checkpoints on
publish, so a SIGKILL'd server restarted on the same DIR recovers to
bit-identical graphs (see ``--fault-plan`` and
``examples/crash_restart_smoke_torch.py`` for the harness that proves it).

    PYTHONPATH=src python examples/serve_graphs_torch.py --port 8080 \\
        --dataset dblp
    curl -s -X POST localhost:8080/v1/extract -d '{"model": "dblp"}'
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.durability import FaultPlan, RetryableError, faults
from repro_torch.serving import (
    AdmissionError,
    DeadlineExceeded,
    GraphService,
    QuotaExceeded,
    ServiceClosed,
    SnapshotNotFound,
    UnknownModel,
)


def build_service(dataset: str = "dblp", scale: int = 1, device=None,
                  **service_kwargs) -> GraphService:
    """A service over one of the repo's synthetic datasets, made on
    ``device`` (``None``: the CUDA card)."""
    if dataset == "dblp":
        from repro_torch.data import make_dblp
        from repro_torch.data.dblp import dblp_model
        db = make_dblp(scale=scale, device=device)
        models = {"dblp": dblp_model()}
    elif dataset == "imdb":
        from repro_torch.data import make_imdb
        from repro_torch.data.imdb import imdb_model
        db = make_imdb(scale=scale, device=device)
        models = {"imdb": imdb_model()}
    elif dataset == "tpcds":
        from repro_torch.data import make_tpcds
        from repro_torch.data.tpcds import fraud_model, recommendation_model
        db = make_tpcds(sf=scale, device=device)
        models = {"fraud_store": fraud_model("store"),
                  "recommendation_store": recommendation_model("store")}
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return GraphService(db, models, **service_kwargs)


class GraphRequestHandler(BaseHTTPRequestHandler):
    """Thin HTTP translation over ``self.server.service``."""

    protocol_version = "HTTP/1.1"
    service: GraphService  # set via make_server()

    # -- plumbing ------------------------------------------------------------
    def _send(self, code: int, payload: dict,
              retry_after: Optional[float] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", f"{max(retry_after, 0.001):.3f}")
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str,
                   content_type: str = "text/plain; version=0.0.4") -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_error(self, code: int, error: str, retryable: bool,
                    retry_after: Optional[float] = None, **extra) -> None:
        """The one non-2xx body shape: error + retryable + trace_id."""
        body = {"error": error, "retryable": bool(retryable),
                "trace_id": self.trace_id, **extra}
        if retry_after is not None:
            body["retry_after"] = max(float(retry_after), 0.001)
        self._send(code, body, retry_after=retry_after)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    @property
    def tenant(self) -> str:
        return self.headers.get("X-Tenant") or "public"

    @property
    def trace_id(self) -> str:
        # one id per request: the client's X-Request-Id if sane, else
        # minted here — identical in the response body and the trace store
        tid = getattr(self, "_trace_id", None)
        if tid is None:
            tid = (obs.sanitize_trace_id(self.headers.get("X-Request-Id"))
                   or obs.new_trace_id())
            self._trace_id = tid
        return tid

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- routes --------------------------------------------------------------
    def do_GET(self) -> None:
        svc = self.server.service
        path, _, query = self.path.partition("?")
        params = dict(p.partition("=")[::2] for p in query.split("&") if p)
        fmt = params.get("format", "json")
        if path == "/healthz":
            # 200 with a status field even when degraded: the process is
            # alive and serving epoch E; "degraded" carries the cause
            self._send(200, svc.healthz())
        elif path == "/v1/stats":
            self._send(200, svc.stats())
        elif path == "/v1/metrics":
            if fmt == "prometheus":
                self._send_text(200, obs.REGISTRY.to_prometheus())
            else:
                self._send(200, obs.REGISTRY.snapshot())
        elif path == "/v1/traces":
            try:
                limit = int(params.get("limit", 50))
            except ValueError:
                limit = 50
            self._send(200, {"traces": obs.TRACER.list_traces(limit=limit)})
        elif path.startswith("/v1/trace/"):
            tid = path[len("/v1/trace/"):]
            spans = obs.TRACER.get(tid)
            if spans is None:
                self._send_error(404, f"no trace {tid!r}", False,
                                 available=obs.TRACER.trace_ids()[-20:],
                                 list="/v1/traces")
            elif fmt == "chrome":
                # explicit type + attachment disposition: the export is a
                # file meant for chrome://tracing / Perfetto, not a browser
                # page (tid is a known trace id, so it is filename-safe)
                raw = json.dumps(obs.TRACER.chrome(tid)).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Disposition",
                                 f'attachment; filename="trace-{tid}.json"')
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
            else:
                self._send(200, {"trace_id": tid, "spans": spans,
                                 "summary": obs.TRACER.summary(tid)})
        elif path == "/v1/models":
            self._send(200, {"models": svc.models()})
        else:
            self._send_error(404, f"no route {self.path}", False)

    def do_POST(self) -> None:
        svc = self.server.service
        try:
            req = self._body()
        except (ValueError, json.JSONDecodeError) as e:
            return self._send_error(400, f"bad JSON: {e}", False)
        deadline_s = req.get("deadline_s")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
        try:
            if self.path == "/v1/extract":
                out = svc.extract(req["model"],
                                  method=req.get("method", "extgraph"),
                                  tenant=self.tenant,
                                  epoch=req.get("epoch"),
                                  request_id=self.trace_id,
                                  deadline_s=deadline_s)
                self._send(200, out)
            elif self.path == "/v1/explain":
                out = svc.explain(req["model"],
                                  method=req.get("method", "extgraph"),
                                  analyze=bool(req.get("analyze", False)),
                                  tenant=self.tenant,
                                  epoch=req.get("epoch"),
                                  request_id=self.trace_id,
                                  deadline_s=deadline_s)
                self._send(200, out)
            elif self.path == "/v1/analyze":
                out = svc.analyze(req["model"],
                                  algorithm=req.get("algorithm", "pagerank"),
                                  method=req.get("method", "extgraph"),
                                  tenant=self.tenant,
                                  epoch=req.get("epoch"),
                                  request_id=self.trace_id,
                                  deadline_s=deadline_s,
                                  **(req.get("params") or {}))
                self._send(200, out)
            elif self.path == "/v1/discover":
                out = svc.discover(
                    req.get("tables"),
                    sample=int(req.get("sample", 512)),
                    use_name_hints=bool(req.get("use_name_hints", True)),
                    accept_threshold=float(
                        req.get("accept_threshold", 0.5)),
                    top=req.get("top"),
                    tenant=self.tenant,
                    epoch=req.get("epoch"),
                    request_id=self.trace_id,
                    deadline_s=deadline_s)
                self._send(200, out)
            elif self.path == "/v1/mutate":
                insert = req.get("insert")
                if insert:
                    insert = {k: np.asarray(v) for k, v in insert.items()}
                dw = req.get("delete_where")
                out = svc.mutate(req["table"], insert=insert,
                                 delete_where=tuple(dw) if dw else None)
                self._send(200, out)
            elif self.path == "/v1/refresh":
                out = svc.refresh()
                if out.get("path") in ("failed", "backoff"):
                    # the previous epoch is still served; the build failed
                    # (or is in its backoff window) — tell the client when
                    # to come back
                    self._send_error(
                        503, out.get("error") or out.get("cause")
                        or "refresh backing off", True,
                        retry_after=out.get("retry_in_s"), **{
                            "path": out["path"], "epoch": out.get("epoch")})
                else:
                    self._send(200, out)
            else:
                self._send_error(404, f"no route {self.path}", False)
        except KeyError as e:
            if isinstance(e, UnknownModel):
                self._send_error(404, str(e), False, available=e.available)
            elif isinstance(e, SnapshotNotFound):
                self._send_error(410, str(e), False, available=e.available)
            else:
                self._send_error(400, f"missing field {e}", False)
        except QuotaExceeded as e:
            self._send_error(429, str(e), True, retry_after=e.retry_after,
                             tenant=e.tenant)
        except AdmissionError as e:
            self._send_error(429, str(e), True, retry_after=e.retry_after)
        except DeadlineExceeded as e:
            self._send_error(504, str(e), True, retry_after=e.retry_after,
                             stage=e.stage)
        except ServiceClosed as e:
            self._send_error(503, str(e), False)
        except RetryableError as e:
            # a transient internal fault that survived the service's own
            # bounded retries — honest 503, client may try again
            self._send_error(503, str(e), True,
                             retry_after=getattr(e, "retry_after", None))
        except ValueError as e:
            self._send_error(400, str(e), False)
        except Exception as e:
            self._send_error(500, f"internal error: "
                             f"{type(e).__name__}: {e}", False)


def make_server(service: GraphService, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False) -> ThreadingHTTPServer:
    """A ready-to-``serve_forever`` threading HTTP server (port 0 = any)."""
    server = ThreadingHTTPServer((host, port), GraphRequestHandler)
    server.service = service
    server.verbose = verbose
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Serve extracted graphs over HTTP (multi-tenant).")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--dataset", default="dblp",
                        choices=("dblp", "imdb", "tpcds"))
    parser.add_argument("--scale", type=int, default=1,
                        help="dataset scale factor")
    parser.add_argument("--workers", type=int, default=4,
                        help="scheduler worker threads")
    parser.add_argument("--warm", action="store_true",
                        help="extract every model once before serving")
    parser.add_argument("--durable-dir", default=None,
                        help="WAL + checkpoint directory; restarting on "
                             "the same dir recovers the served state")
    parser.add_argument("--fault-plan", default=None,
                        help="fault-injection plan: inline JSON or "
                             "@path/to/plan.json (testing only)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the data and the engine")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.fault_plan:
        spec = args.fault_plan
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        plan = FaultPlan.from_json(spec)
        faults.install(plan)
        print(f"fault plan installed: {[r.spec() for r in plan.rules]}")

    service = build_service(args.dataset, scale=args.scale,
                            device=args.device, max_workers=args.workers,
                            durable_dir=args.durable_dir)
    if service.recovery is not None:
        print(f"recovered: {service.recovery.summary()}")
    if args.warm:
        for name in service.models():
            r = service.extract(name)
            print(f"warmed {name}: {sum(r['edges'].values())} edges")
    server = make_server(service, host=args.host, port=args.port,
                         verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"serving {args.dataset} on http://{host}:{port} "
          f"(models: {', '.join(service.models())})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
