#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. The card: ``nvidia-smi`` name and power limit, ``torch`` device name.
2. The build: every CUDA kernel of the join path, built cold with ``nvcc``
   (one process per source, in parallel); build seconds and ptxas usage.
3. Every kernel against its plain PyTorch version on the card, at the main
   path's shapes (TPC-DS SF1 fact/dimension key columns) and at the edge
   cases (empty sides, all-NULL keys, negative keys).  Results must be
   exactly equal (integer outputs: tolerance 0).  Each is timed with CUDA
   events beside its plain version, the one PyTorch call that computes the
   same function where there is one, and its bound (the least time the
   card could take: bytes over 3.35 TB/s or integer operations over
   67 T/s, whichever is larger).
4. The JS-OJ path: ``ExtractionEngine.extract(fraud_model("store"))`` on
   ``make_tpcds(sf=1000)``, cold then warm.  ``Buy`` and ``Sell`` must
   equal the numpy bags (c_sk, i_sk) and (o_sk, i_sk) of store_sales, and
   the plain-torch path's digests.
5. The JS-MV path: ``ExtractionEngine.extract(dblp_model())`` on
   ``make_dblp(scale=100)``, cold (view built) then warm (plan cache hit,
   view reused); edge counts against numpy, digests against the plain path.

Launch counters are set to 0 just before each path and read just after;
every kernel must have launched inside each path.  The last lines are a
JSON object of the kernels, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failed check raises (exit != 0).
Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TPCDS_SF = 1000        # store_sales 2.88M rows: TPC-DS SF1's fact size
DBLP_SCALE = 100       # wrote 1.8M rows, Auth-Edit ~18M edges

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (fp32 table)
HASH_OPS = 6                  # multiply, add, shift, xor, modulo, or/test


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
            f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_kernels(torch, kops, ref, tpcds_np):
    """Phase 3: each kernel against its plain version, exact, and timed."""
    import numpy as np

    dev = torch.device("cuda")
    null = np.int32(2**31 - 1)
    fact_i = torch.from_numpy(tpcds_np["i_sk"]).to(dev)       # 2.88M
    item_sorted = torch.from_numpy(np.sort(tpcds_np["i_id"])).to(dev)
    fact_sorted = torch.sort(fact_i).values
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    edge_probe = [
        ("empty probe", t(np.arange(100)), t([])),
        ("empty build", t([]), t([-3, 0, 7])),
        ("all NULL", t(np.full(16, null)), t(np.full(7, null))),
        ("NULL tail", t([1, 5, 5, null, null]), t([null, null, 5, 0])),
        ("negative keys", t(np.sort(rng.integers(-1000, 1000, 5000))),
         t(rng.integers(-2**31, 2**31 - 1, 3000))),
    ]
    for name, sk, pk in edge_probe:
        lo, hi = kops.sorted_probe(sk, pk)
        rlo, rhi = ref.sorted_probe(sk, pk)
        err = max(max_abs_err(torch, lo, rlo), max_abs_err(torch, hi, rhi))
        assert err == 0, f"sorted_probe {name}: max_abs_err {err}"
    keys_all_null = t(np.full(1000, null))
    edge_bloom = [
        ("empty", t([]), torch.zeros(0, dtype=torch.bool, device=dev), 256),
        ("all NULL invalid", keys_all_null,
         torch.zeros(1000, dtype=torch.bool, device=dev), 256),
        ("all NULL valid", keys_all_null,
         torch.ones(1000, dtype=torch.bool, device=dev), 16384),
        ("negative keys", t(rng.integers(-2**31, 0, 5000)),
         torch.from_numpy(rng.random(5000) < 0.7).to(dev), 1024),
    ]
    for name, keys, valid, nbits in edge_bloom:
        bits = kops.bloom_build(keys, valid, nbits)
        rbits = ref.bloom_build(keys, valid, nbits)
        err = max_abs_err(torch, bits, rbits)
        assert err == 0, f"bloom_build {name}: max_abs_err {err}"
        probe = torch.cat([keys, t([-5, 0, null])])
        err = max_abs_err(torch, kops.bloom_probe(bits, probe),
                          ref.bloom_probe(rbits, probe))
        assert err == 0, f"bloom_probe {name}: max_abs_err {err}"
    log("edge cases: sorted_probe", len(edge_probe), "bloom",
        len(edge_bloom), "all exact")

    rows = []

    def record(name, source, replaces, cases):
        """cases: [(label, run_kernel, run_plain, run_library, nbytes, ops)]"""
        out_cases = []
        worst = 0
        for label, run_k, run_p, run_l, nbytes, ops in cases:
            got, want = run_k(), run_p()
            if isinstance(got, tuple):
                err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
            else:
                err = max_abs_err(torch, got, want)
            assert err == 0, f"{name} {label}: max_abs_err {err}"
            worst = max(worst, err)
            # turns: plain, kernel, kernel, plain
            p1 = cuda_ms(torch, run_p)
            k1 = cuda_ms(torch, run_k)
            k2 = cuda_ms(torch, run_k)
            p2 = cuda_ms(torch, run_p)
            lib = cuda_ms(torch, run_l) if run_l is not None else None
            b, by = bound_ms(nbytes, ops)
            out_cases.append({"shape": label, "ms": min(k1, k2),
                              "plain_ms": min(p1, p2), "library_ms": lib,
                              "bound_ms": b, "bound_by": by})
            log(f"  {name} [{label}] kernel {min(k1, k2):.4f} ms, plain "
                f"{min(p1, p2):.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{b:.4f} ms ({by})")
        head = out_cases[0]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": worst, "ms": head["ms"],
                     "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                     "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"], "cases": out_cases})

    def probe_case(label, sk, pk):
        s, p = sk.shape[0], pk.shape[0]
        depth = int(np.ceil(np.log2(max(s, 2)))) + 1
        return (label,
                lambda: kops.sorted_probe(sk, pk),
                lambda: ref.sorted_probe(sk, pk),
                lambda: (torch.searchsorted(sk, pk, out_int32=True),
                         torch.searchsorted(sk, pk, right=True,
                                            out_int32=True)),
                4 * s + 4 * p + 8 * p, 2 * depth * p)

    record("sorted_probe", "src/repro_torch/kernels/csrc/sorted_probe.cu",
           "src/repro/kernels/sorted_probe.py:45",
           [probe_case(f"P={fact_i.shape[0]} into S={fact_sorted.shape[0]}",
                       fact_sorted, fact_i),
            probe_case(f"P={fact_i.shape[0]} into S={item_sorted.shape[0]}",
                       item_sorted, fact_i)])

    nbits = kops.bloom_bits_for(fact_i.shape[0])
    valid = torch.ones(fact_i.shape, dtype=torch.bool, device=dev)
    n = fact_i.shape[0]
    record("bloom_build", "src/repro_torch/kernels/csrc/bloom.cu",
           "src/repro/kernels/bloom.py:29",
           [(f"N={n} bits={nbits}",
             lambda: kops.bloom_build(fact_i, valid, nbits),
             lambda: ref.bloom_build(fact_i, valid, nbits),
             None, 5 * n + 4 * nbits, 2 * HASH_OPS * n)])
    bits = ref.bloom_build(item_sorted, torch.ones_like(item_sorted,
                                                        dtype=torch.bool),
                           nbits)
    record("bloom_probe", "src/repro_torch/kernels/csrc/bloom.cu",
           "src/repro/kernels/bloom.py:48",
           [(f"N={n} bits={nbits}",
             lambda: kops.bloom_probe(bits, fact_i),
             lambda: ref.bloom_probe(bits, fact_i),
             None, 4 * nbits + 5 * n, 2 * HASH_OPS * n)])
    return rows


def drive(torch, kops, engine, model, label):
    """Cold then warm extract between a counter reset and a counter read."""
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    cold = engine.extract(model)
    warm = engine.extract(model)
    counts = kops.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    assert not missing, f"{label}: kernels never launched: {missing}"
    rows = {lab: int(t.valid.sum()) for lab, t in cold.edges.items()}
    assert rows == {lab: int(t.valid.sum()) for lab, t in warm.edges.items()}
    assert cold.graph.fingerprint() == warm.graph.fingerprint()
    log(f"{label}: rows {rows}")
    log(f"{label}: extract_s cold {cold.timings.extract_s:.4f} warm "
        f"{warm.timings.extract_s:.4f}; plan_s cold "
        f"{cold.timings.plan_s:.4f} warm {warm.timings.plan_s:.4f}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{counts}")
    return cold, warm, counts, rows


def digests(edges):
    from repro_torch.relational.ops import table_digest

    return {lab: table_digest(t) for lab, t in edges.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.api import ExtractionEngine
    from repro_torch.core.pipeline import PipelineCompiler
    from repro_torch.data import (dblp_model, fraud_model, make_dblp,
                                  make_tpcds)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.relational import Table
    from repro_torch.relational.ops import table_digest

    assert "jax" not in sys.modules and "repro" not in sys.modules

    # 1. the card
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. the build (cold in a fresh checkout: build/ is not committed)
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(logs) or 'nothing (already built)'}")
    for src, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{src}]: {line.strip()}")

    # 4's data first: phase 3 takes its shapes from it
    t0 = time.perf_counter()
    tpcds = make_tpcds(sf=TPCDS_SF)
    torch.cuda.synchronize()
    log(f"data: make_tpcds(sf={TPCDS_SF}) {time.perf_counter() - t0:.2f} s,"
        f" store_sales {tpcds.stats['store_sales'].rows} rows")
    ss = {c: tpcds.table("store_sales")[c].cpu().numpy()
          for c in ("c_sk", "i_sk", "o_sk")}
    fact_np = {"i_sk": ss["i_sk"],
               "i_id": tpcds.table("item")["i_id"].cpu().numpy()}

    # 3. kernels against their plain versions
    log("kernels vs plain (exact), CUDA-event times:")
    kernel_rows = check_kernels(torch, kops, ref, fact_np)

    # 4. the JS-OJ path
    model = fraud_model("store")
    cold, warm, counts_oj, rows_oj = drive(
        torch, kops, ExtractionEngine(tpcds), model,
        f"JS-OJ fraud_model(store) sf={TPCDS_SF}")
    plan_units = [("merged" if not u.is_single else "single")
                  for u in cold.plan.units]
    log(f"  plan units {plan_units}, views {[v.name for v in cold.plan.views]}")
    assert "merged" in plan_units, "expected a JS-OJ merged unit"

    def host_digest(src, dst):
        return table_digest(Table.from_arrays(device="cpu", src=src, dst=dst))

    want = {"Buy": host_digest(ss["c_sk"], ss["i_sk"]),
            "Sell": host_digest(ss["o_sk"], ss["i_sk"])}
    got = digests(cold.edges)
    assert got == want, f"JS-OJ edges differ from numpy: {got} vs {want}"
    plain = ExtractionEngine(tpcds, compiler=PipelineCompiler(
        use_kernel=False, use_bloom=False)).extract(model)
    assert digests(plain.edges) == got, "JS-OJ kernel path != plain path"
    log("  edges == numpy bags == plain-torch path")
    del plain, cold, warm, tpcds
    torch.cuda.empty_cache()

    # 5. the JS-MV path
    t0 = time.perf_counter()
    dblp = make_dblp(scale=DBLP_SCALE)
    torch.cuda.synchronize()
    log(f"data: make_dblp(scale={DBLP_SCALE}) "
        f"{time.perf_counter() - t0:.2f} s, wrote "
        f"{dblp.stats['wrote'].rows} rows")
    model = dblp_model()
    cold, warm, counts_mv, rows_mv = drive(
        torch, kops, ExtractionEngine(dblp), model,
        f"JS-MV dblp_model scale={DBLP_SCALE}")
    log(f"  cold {cold.provenance}\n  warm {warm.provenance}")
    assert cold.provenance.views_built, "cold request built no view"
    assert warm.provenance.plan_cache_hit, "warm request missed the plan"
    assert warm.provenance.views_reused, "warm request reused no view"
    wrote = {c: dblp.table("wrote")[c].cpu().numpy() for c in ("a_sk", "p_sk")}
    v_of_paper = dblp.table("paper")["v_sk"].cpu().numpy()
    n_venue = dblp.stats["venue"].rows
    per_paper = np.bincount(wrote["p_sk"]).astype(np.int64)
    editors = np.bincount(dblp.table("edits")["v_sk"].cpu().numpy(),
                          minlength=n_venue).astype(np.int64)
    want_rows = {"Co-auth": int((per_paper ** 2).sum()),
                 "Auth-Edit": int(editors[v_of_paper[wrote["p_sk"]]].sum())}
    assert rows_mv == want_rows, f"JS-MV rows {rows_mv} != numpy {want_rows}"
    plain = ExtractionEngine(dblp, compiler=PipelineCompiler(
        use_kernel=False, use_bloom=False)).extract(model)
    assert digests(plain.edges) == digests(cold.edges), \
        "JS-MV kernel path != plain path"
    log("  edge counts == numpy; digests == plain-torch path")

    for row in kernel_rows:
        row["launches"] = counts_oj[row["name"]] + counts_mv[row["name"]]
        row["launches_by_path"] = {"js_oj": counts_oj[row["name"]],
                                   "js_mv": counts_mv[row["name"]]}
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
