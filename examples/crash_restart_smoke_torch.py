"""Crash-restart smoke of the PyTorch port: SIGKILL a durable server
mid-refresh, recover, verify.

The counterpart of ``examples/crash_restart_smoke.py`` against
``examples/serve_graphs_torch.py``; the server and the reference run put
their data on ``--device`` (default: the CUDA card).  End-to-end drill of
the durability contract against the real HTTP server:

1. Launch ``serve_graphs_torch.py --durable-dir D`` with a fault plan that makes
   the *second* refresh hang mid-flight (after the first has published a
   manifest), so the kill lands exactly in the window the WAL exists for.
2. Extract, mutate (deterministic batch), refresh (→ manifest at P),
   extract the published fingerprint, mutate again (unpublished WAL
   tail), start the hanging refresh, and SIGKILL the process.
3. Restart on the same durable dir: the recovered server must report a
   checkpoint recovery, serve the *published* fingerprint bit-identically,
   and — after one ordinary refresh — serve the same fingerprint an
   uninterrupted in-process reference run produces over the identical
   mutation history.  ``healthz`` must be ``ok`` throughout.

Exits non-zero on any violation::

    PYTHONPATH=src python examples/crash_restart_smoke_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = os.path.join(REPO, "examples", "serve_graphs_torch.py")

HANG_SECOND_REFRESH = json.dumps({"rules": [{
    "site": "refresh.midflight", "action": "delay",
    "delay_s": 60, "after": 1}]})

# deterministic mutation batches, replayed identically by the reference run
BATCH_PUBLISHED = ("wrote", {"rid": [90001, 90002, 90003],
                             "a_sk": [1, 2, 3], "p_sk": [10, 11, 12]})
BATCH_TAIL = ("wrote", {"rid": [90004, 90005],
                        "a_sk": [4, 5], "p_sk": [13, 14]})


def _post(port: int, route: str, payload: dict, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port: int, route: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _launch(durable: str, device: str, fault_plan: str = None) -> tuple:
    """Start serve_graphs_torch on an ephemeral port; return (proc, port)."""
    cmd = [sys.executable, SERVE, "--dataset", "dblp", "--port", "0",
           "--workers", "2", "--durable-dir", durable, "--device", device]
    if fault_plan:
        cmd += ["--fault-plan", fault_plan]
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    deadline = time.time() + 120
    port = None
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"server exited early (rc={proc.poll()})")
        sys.stdout.write(f"  [server] {line}")
        m = re.search(r"serving .* on http://[^:]+:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        raise RuntimeError("server never printed its serving line")
    # drain stdout in the background so the server never blocks on a full
    # pipe (its request log would otherwise wedge it)
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc, port


def _reference_fingerprint(device: str) -> str:
    """What an uninterrupted run serves after the same mutation history."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from serve_graphs_torch import build_service
    svc = build_service("dblp", device=device, max_workers=2)
    try:
        svc.extract("dblp")
        for table, insert in (BATCH_PUBLISHED, BATCH_TAIL):
            svc.mutate(table, insert=insert)
        assert svc.refresh()["path"] == "published"
        return svc.extract("dblp")["fingerprint"]
    finally:
        svc.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the servers' data")
    device = parser.parse_args(argv).device
    workdir = tempfile.mkdtemp(prefix="crash_restart_")
    durable = os.path.join(workdir, "durable")
    proc = None
    try:
        print("== phase 1: durable server, publish, tail, SIGKILL mid-refresh")
        proc, port = _launch(durable, device, fault_plan=HANG_SECOND_REFRESH)
        fp0 = _post(port, "/v1/extract", {"model": "dblp"})["fingerprint"]
        print(f"  initial fingerprint {fp0}")
        _post(port, "/v1/mutate",
              {"table": BATCH_PUBLISHED[0], "insert": BATCH_PUBLISHED[1]})
        out = _post(port, "/v1/refresh", {})
        assert out["path"] == "published", out
        fp_published = _post(port, "/v1/extract",
                             {"model": "dblp"})["fingerprint"]
        print(f"  published fingerprint {fp_published} (epoch {out['epoch']})")
        _post(port, "/v1/mutate",
              {"table": BATCH_TAIL[0], "insert": BATCH_TAIL[1]})

        # the second refresh hangs mid-flight (fault plan) — kill it there
        def _hanging_refresh():
            try:
                _post(port, "/v1/refresh", {}, timeout=5)
            except Exception:
                pass            # expected: the server dies under us
        hang = threading.Thread(target=_hanging_refresh, daemon=True)
        hang.start()
        time.sleep(1.0)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        print(f"  killed server (rc={proc.returncode}) mid-refresh")

        print("== phase 2: restart on the same durable dir")
        proc, port = _launch(durable, device)
        health = _get(port, "/healthz")
        assert health.get("status") == "ok", health
        assert health.get("recovery"), health
        assert health["recovery"]["path"] == "checkpoint", health
        print(f"  recovery: {health['recovery']}")

        got_p = _post(port, "/v1/extract", {"model": "dblp"})["fingerprint"]
        assert got_p == fp_published, (
            f"recovered served {got_p} != published pre-crash "
            f"{fp_published}")
        print(f"  published-epoch parity OK ({got_p})")

        out = _post(port, "/v1/refresh", {})
        assert out["path"] in ("published", "noop"), out
        got_l = _post(port, "/v1/extract", {"model": "dblp"})["fingerprint"]
        ref_l = _reference_fingerprint(device)
        assert got_l == ref_l, (
            f"post-refresh served {got_l} != uninterrupted reference "
            f"{ref_l}")
        print(f"  WAL-tail parity OK ({got_l})")

        health = _get(port, "/healthz")
        assert health.get("status") == "ok", health
        print("== crash-restart smoke PASSED")
        return 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
