#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. The card: ``nvidia-smi`` name and power limit, ``torch`` device name.
2. The build: every CUDA kernel, built cold with ``nvcc`` (one process per
   source, in parallel); build seconds and ptxas usage, and the flash
   kernel's registers and spills for each head-dim template.
3. Every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at the edge cases.  Integer and bool outputs must be
   exactly equal (tolerance 0).  ``edge_spmv`` sums float32 with atomics in
   an order that changes from run to run, so it and its plain version are
   each held, per vertex, to twice the recursive-summation bound of a
   float64 sum of the same inputs:
   ``|y - y64| <= 2 * deg_in(v) * 2**-24 * sum |x[u]| + 1e-30``.  Each
   kernel is timed with CUDA events beside its plain version, the one
   PyTorch call that computes the same function where there is one, and
   its bound (the least time the card could take: bytes over 3.35 TB/s or
   integer operations over 67 T/s, whichever is larger); a line gives the
   kernel / library ratio, which compares across machines.  Beside the
   per-call time (``ms``, which holds the host's dispatch when that is
   longer than the kernel) each case gets ``device_ms``: the kernels,
   fills and copies ``torch.profiler`` records on the card over 20 more
   launches, per call, and how many of them a call puts on the stream.  A
   capture counts only if it holds the wrapper's own kernel
   (``<name>_kernel``); when none of ``PROFILE_TRIES`` does, a CUDA-graph
   replay gives the time.  The join kernels
   (TPC-DS SF1 key columns) run first, with a probe edge case whose runs
   of one key are far longer than the probe's fence stride; the graph
   kernels run on the JS-OJ graph's CSR (phase 6's shapes), with edge
   cases aimed at the shared-memory
   table of ``edge_spmv`` and ``edge_min_label`` at that size (every edge
   into one vertex, more distinct destinations in a block's range than
   table slots, destinations past the probe bound, runs longer than a
   block's range).  ``edge_min_label`` is timed on WCC's first labels and
   on the labels after one step, which its later launches see.
4. The JS-OJ path: ``ExtractionEngine.extract(fraud_model("store"))`` on
   ``make_tpcds(sf=1000)``, cold then warm.  ``Buy`` and ``Sell`` must
   equal the numpy bags (c_sk, i_sk) and (o_sk, i_sk) of store_sales, and
   the plain-torch path's digests.  The kernel phase replays phases 4-5
   with every ``bloom_build`` and ``bloom_prune_keys`` launch recorded (the
   join's pruning: the probe kernel in its prune mode, counted as
   ``bloom_probe``): it logs their (N, num_bits) and checks and times both
   kernels at the largest and the most frequent, with the bits the path
   built: ``bloom_probe`` itself, ``bloom_prune_keys`` beside the two calls
   it replaces (``bloom_probe`` + ``torch.where``, timed in the same run),
   and ``bloom_probe`` at N = 1 (its prologue alone).
5. The JS-MV path: ``ExtractionEngine.extract(dblp_model())`` on
   ``make_dblp(scale=100)``, cold (view built) then warm (plan cache hit,
   view reused); edge counts against numpy, digests against the plain path.
6. Analytics on the JS-OJ graph (V = 600,502, E = 5,760,000):
   ``engine.analyze`` PageRank on ``Buy`` cold then warm (CSR and plan
   cache hits), then WCC, k-hop (8 seeds, k = 3) and degree statistics.
   WCC, k-hop and the degrees must equal the numpy ground truth
   (``repro_torch.graph.reference``) exactly.  PageRank, on the kernels
   and on the plain-torch path, must be within ``D_max * 2**-24`` of the
   float64 ground truth in L1 (the ranks sum to 1) and in max relative
   error, where ``D_max`` is the largest in-degree: a float32 sum over that
   hub may be off by this much relative (the recursive-summation bound),
   and every vertex's rank shares the error through the dangling mass.
   The CSR built through the ``segment_counts`` kernel must equal the plain
   build array for array.  The kernel phase replays the phase with every
   ``segment_counts`` launch recorded, and checks and times the kernel on
   each distinct operand (the CSR build's sources in extraction order,
   PageRank's out-degree, the degree statistics' sources and targets),
   labelled by call site, and ``frontier_expand`` on each of k-hop's three
   launch operands, bounded by the bytes any kernel must read for the
   operand (a flag per edge, a source per valid edge, a destination per
   valid edge from the frontier, the fill of the output).
7. Analytics on the JS-MV graph (dblp scale=100, ~25M edges): PageRank and
   WCC through the kernels against the plain-torch path on the same CSR:
   WCC exactly, PageRank to the tolerance of phase 6.  Then ``edge_spmv``
   on PageRank's edges and ``edge_min_label`` on WCC's (first step and
   second), checked and timed as in phase 3, and ``segment_counts`` on the
   operands of its launches (replayed), as in phase 6.
8. The LM serving path.  (a) ``flash_attention`` against its plain version
   in bf16 at the main path's shapes (qwen2.5-3b prefill B 4 x S 2048,
   16/2 heads, Dh 128, causal; gemma-2b Dh 256; h2o-danube-3-4b S 8192,
   Dh 120, window 4096) and at the edge cases (S 4096 wraps the K/V ring
   of shared memory many times), to the reference test's
   rtol = atol = 2e-2: the kernel rounds the probabilities to bf16 before
   P V, the plain version does not, and both round the output to bf16 once,
   so they may sit a bf16 ulp or two apart.  Timed like phase 3; its bound
   counts the attended (i, j) pairs of this run (4 Dh flops each) over the
   989 TFLOP/s of bf16 tensor cores, and its library yardstick is
   ``scaled_dot_product_attention``.  (b) qwen2.5-3b at full width on one
   card (36 layers, d 2048, vocab 151,936; random bf16 weights from a seeded
   ``torch.Generator``): ``prefill`` of 4 prompts of 2,048 tokens, then 32
   greedy ``decode_step``s, with the flash kernel launched once per layer
   of the prefill.  Then the same prefill and first decode step on the
   plain attention path: the last logits and the first step's logits must
   agree to ``LM_REL_TOL`` x std(logits) (see there).

9. Refresh and recovery.  (a) JS-OJ: ``fraud_model("store")`` on a fresh
   ``make_tpcds(sf=1000)``, extracted cold and warm, PageRank analysed so a
   CSR is cached, then four ``engine.refresh`` rounds: 28,800 store_sales
   rows in and 14,400 out (the delta path; the cached CSR patched), 1,000
   new items (delta; the vertex set changes, no patch), 432,000 rows out
   (or more, until the churn exceeds the 0.1 threshold: the full path),
   nothing (noop).  Each round must take its path and give the digests of
   every vertex and edge table of a from-scratch extraction on the plain
   path (a new database, exact ANALYZE, a new engine whose compiler
   launches no kernel); after round 1, the patched CSR's live (src, dst)
   multiset of every label must equal the fresh plain build's, PageRank on
   it meets phase 6's ``D_max * 2**-24`` check against plain PageRank on
   that build, and WCC equals plain WCC there.  (b) JS-MV:
   ``dblp_model()`` on a fresh ``make_dblp(scale=100)``; 18,000 wrote rows
   in and 9,000 out; the delta path with the view maintained, digests
   against a plain-path fresh extraction.
   (c) A WAL in a temporary directory is attached to (a)'s database before
   round 1 and a manifest written after round 2; after round 4 the WAL is
   abandoned and ``recover_database`` rebuilds the database on the card:
   its fingerprint, every table's digest and capacity, and the graph an
   engine extracts from it must equal the live ones.  Logged: each
   refresh's ``extract_s`` beside the cold and warm ones, the host fold's
   (``apply_table_delta``) share, the delta terms, the peak device memory,
   and the seconds of the manifest write, the recovery, and its restore and
   replay.  The delta refreshes must launch ``sorted_probe``,
   ``bloom_build`` and ``bloom_probe``.

The phases run in their order, each kernel case checked and timed with
CUDA events where it stands.  Then a kernel phase: the kernel cases of 4-7
on the operands the paths' launches saw, taken from an untimed replay of
each path on regenerated data with the wrappers recorded (``replay``, which
checks that the replay launched every kernel as often as the timed run);
then phase 9's three delta refreshes replayed alike (the same seeded
churn), every one of their ``sorted_probe``, ``bloom_build`` and
``bloom_prune_keys`` launches held exactly against its plain version and
the largest and most frequent operands of each timed; and last every
case's device time (``torch.profiler``, on operands rebuilt alike).  So no profiler session and no recorded operand comes before or
during a path's timed run, nor a profiler session before a CUDA-event
timing: after one, the host's launches are slower.

Launch counters are set to 0 just before each of phases 4–7 and 8b, and
before each refresh of phase 9, and read just after; every kernel of a path
must have launched inside it.  The last
lines are a JSON object of the kernels, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failed check raises (exit != 0).
Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import collections
import contextlib
import functools
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

JOIN_KERNELS = ("sorted_probe", "bloom_build", "bloom_probe")
BLOOM_SOURCE = "src/repro_torch/kernels/csrc/bloom.cu"
BLOOM_REPLACES = "src/repro/kernels/bloom.py:29"
PROBE_REPLACES = "src/repro/kernels/bloom.py:48"
FRONTIER_SOURCE = "src/repro_torch/kernels/csrc/frontier.cu"
FRONTIER_REPLACES = "src/repro/kernels/frontier.py:28"
NULL_KEY = 2**31 - 1
SEGMENT_SOURCE = "src/repro_torch/kernels/csrc/segment_csr.cu"
SEGMENT_REPLACES = "src/repro/kernels/segment_csr.py:24"
GRAPH_KERNELS = ("segment_counts", "edge_spmv", "edge_min_label",
                 "frontier_expand")
SPMV_BOUND_FACTOR = 2.0       # x the recursive-summation bound
PROFILE_TRIES = 4
# the shared-memory table of csrc/spmv.cu and csrc/label_prop.cu: its
# multiplicative hash, 2**12 slots, probes of at most 16 slots
TABLE_HASH, TABLE_SLOT_BITS, TABLE_MAX_PROBE = 2654435769, 12, 16
KHOP_SEEDS, KHOP_K = 8, 3
PR_ITERS = 20
# phase 9's churn on JS-OJ's store_sales (2.88M rows) and JS-MV's wrote
# (1.8M rows): ~1% in then 0.5% out (delta path, CSR patched), 1,000 new
# items (delta, the vertex set changes), 15% out (full), nothing (noop)
REFRESH_INSERT, REFRESH_DELETE = 28_800, 14_400
ITEM_INSERT = 1_000
FULL_DELETE = 432_000
MV_INSERT, MV_DELETE = 18_000, 9_000
OJ_SEED, MV_SEED = 9, 10

BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
FLASH_TOL = 2e-2              # rtol = atol of tests/test_kernels.py
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 32
# max |kernel - plain| / std(plain logits).  The two paths differ only in
# where the attention probabilities are rounded to bf16, so each layer's
# attention output may move by a bf16 ulp (2**-8 relative), and the moves
# of 36 layers carry through the residual stream to the logits.  Measured
# on the CPU at depth 36 (d 64-256, vocab 4096) with float32 probabilities
# on one side: 0.08, the max over 16k logits; over 4 x 151,936 it sits a
# little further out.  A mask or indexing fault moves logits by O(1) x std.
LM_REL_TOL = 0.25


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


def device_time(torch, fn, kernel: str, iters: int = 20, warmup: int = 3):
    """(ms, operations) on the card per call of ``fn``: the kernels, fills
    and copies that ``torch.profiler`` records over ``iters`` calls, without
    the host's dispatch: the larger of two captures.  A capture counts only
    if it holds ``kernel`` (the wrapper's CUDA kernel, by name) at least
    every other call, and is taken again otherwise (up to
    ``PROFILE_TRIES``); when none holds it, the time comes from a CUDA-graph
    replay of the calls (operations None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # each operation's mean time x its launches a call: a few events
        # the profiler drops do not lower the sum
        us, ops, held = 0.0, 0, False
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    2 * e.count >= iters:
                per_call = round(e.count / iters) or 1
                us += e.self_device_time_total / e.count * per_call
                ops += per_call
                held = held or kernel in e.key
        if held:
            seen.append((us / 1e3, ops))
        else:
            log(f"  (a profiler capture lacks {kernel}: taken again)")
        if len(seen) == 2:
            # now and then a capture drops most events of a kernel, and
            # its sum reads low: of two captures, the larger
            return max(seen)
    if seen:
        return seen[0]
    log(f"  (no profiler capture held {kernel}: CUDA-graph replay)")
    return graph_ms(torch, fn, iters), None


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``iters`` calls: device time without the host's dispatch.  Warmed up
    on the capture stream first, so per-stream state (the Bloom build's
    scratch) exists before the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def recording(kops, name: str):
    """Swap ``kops.<name>`` for a recorder while the block runs: each call
    appends (call site, args) to the yielded list and goes on to the
    wrapper, whose launch count counts it as before.  The list holds every
    operand, so only untimed replays (``replay``) record."""
    wrapper, calls = getattr(kops, name), []

    def record(*args, **kwargs):
        caller = sys._getframe(1)
        calls.append((f"{caller.f_code.co_name} < "
                      f"{caller.f_back.f_code.co_name}", args))
        return wrapper(*args, **kwargs)

    setattr(kops, name, record)
    try:
        yield calls
    finally:
        setattr(kops, name, wrapper)


def distinct_calls(torch, calls):
    """[(label, args)] of the recorded calls with distinct operands (the
    first tensor argument), in order; the label names the call site and
    numbers the site's distinct operands (#0, #1, ...)."""
    out, seen = [], {}
    for site, args in calls:
        prior = seen.setdefault(site, [])
        if any(p.shape == args[0].shape and torch.equal(p, args[0])
               for p in prior):
            continue
        out.append((f"{site} #{len(prior)}", args))
        prior.append(args[0])
    return out


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S):
    """The larger of bytes over HBM bandwidth and operations over their peak
    rate (32-bit integer by default; bf16 tensor cores for attention)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
            f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def flash_ptxas(log_text: str):
    """[(head-dim template, "N registers, ... spill ...")] from the flash
    kernel's ptxas -v log, one entry per template instantiation."""
    import re

    out, template = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '.*kernelILi(\d+)E", line)
        if m:
            template, spill = m.group(1), ""
        elif template and "spill" in line:
            spill = line.strip()
        elif template and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((template, f"{regs} registers, {spill}"))
            template = None
    assert out, "no flash_attention template in the ptxas log"
    return out


def record_rows(torch, rows, name, source, replaces, cases, compare=None,
                device=True):
    """Check and time each case of one kernel; append its JSON row (or add
    the cases to the kernel's row, when it has one already) and return it.

    cases: [(label, run_kernel, run_plain, run_library, nbytes, ops)], with
    an optional seventh item, the operations' peak rate (``bound_ms``).
    ``compare(got, want) -> max_abs_err`` raises when the two disagree
    beyond the kernel's tolerance; the default demands exact equality.
    ``device=False`` leaves ``device_ms`` to ``add_device_times`` (a
    profiler session must not precede the paths' timed runs).
    """
    out_cases = []
    worst = 0
    for label, run_k, run_p, run_l, nbytes, ops, *rate in cases:
        got, want = run_k(), run_p()
        if compare is not None:
            err = compare(got, want)
        elif isinstance(got, tuple):
            err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        else:
            err = max_abs_err(torch, got, want)
        if compare is None:
            assert err == 0, f"{name} {label}: max_abs_err {err}"
        worst = max(worst, err)
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(torch, run_p)
        k1 = cuda_ms(torch, run_k)
        k2 = cuda_ms(torch, run_k)
        p2 = cuda_ms(torch, run_p)
        lib = cuda_ms(torch, run_l) if run_l is not None else None
        dev_ms, dev_ops = (device_time(torch, run_k, f"{name}_kernel")
                           if device else (None, None))
        b, by = bound_ms(nbytes, ops, *rate)
        ms = min(k1, k2)
        ratio = None if lib is None else ms / lib
        out_cases.append({"shape": label, "ms": ms, "device_ms": dev_ms,
                          "device_ops_per_call": dev_ops,
                          "plain_ms": min(p1, p2), "library_ms": lib,
                          "library_ratio": ratio,
                          "bound_ms": b, "bound_by": by})
        dev = "later" if dev_ms is None else \
            f"{dev_ms:.4f} ms in {dev_ops} operations a call"
        log(f"  {name} [{label}] kernel {ms:.4f} ms (device {dev}), plain "
            f"{min(p1, p2):.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{b:.4f} ms ({by})"
            + ("" if ratio is None else f"; kernel / library {ratio:.3f}"))
    row = next((r for r in rows if r["name"] == name), None)
    if row is not None:                   # more cases of a kernel's row
        row["cases"] += out_cases
        row["max_abs_err"] = max(row["max_abs_err"], worst)
        return row
    head = out_cases[0]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0,
           "max_abs_err": worst, "ms": head["ms"],
           "device_ms": head["device_ms"],
           "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
           "bound_by": head["bound_by"],
           "library_ms": head["library_ms"], "cases": out_cases}
    rows.append(row)
    return row


def add_device_times(torch, rows, name, cases):
    """``device_ms`` of the cases ``record_rows(..., device=False)`` left
    without it, on ``cases`` (record_rows' form) rebuilt alike, by label."""
    row = next(r for r in rows if r["name"] == name)
    for label, run_k, *_ in cases:
        out = next(c for c in row["cases"] if c["shape"] == label)
        assert out["device_ms"] is None, f"{name} [{label}] timed twice"
        out["device_ms"], out["device_ops_per_call"] = device_time(
            torch, run_k, f"{name}_kernel")
        log(f"  {name} [{label}] device {out['device_ms']:.4f} ms in "
            f"{out['device_ops_per_call']} operations a call")
    row["device_ms"] = row["cases"][0]["device_ms"]


def probe_case(torch, kops, ref, label, sk, pk):
    """A ``record_rows`` case of sorted_probe, with two ``searchsorted``
    calls as the library call: the sorted keys and the probe keys read
    once, two int32 bounds written per probe key; a bisection's compares."""
    s, p = sk.shape[0], pk.shape[0]
    depth = (max(s, 2) - 1).bit_length() + 1     # ceil(log2 s) + 1
    return (label,
            lambda: kops.sorted_probe(sk, pk),
            lambda: ref.sorted_probe(sk, pk),
            lambda: (torch.searchsorted(sk, pk, out_int32=True),
                     torch.searchsorted(sk, pk, right=True, out_int32=True)),
            4 * s + 4 * p + 8 * p, 2 * depth * p)


def segment_case(torch, kops, ref, label, values, valid, n):
    """A ``record_rows`` case of segment_counts on one operand, with
    ``bincount`` of its valid in-range values as the library call;
    ``{live}`` in ``label`` becomes the count of valid slots."""
    counted = values[valid & (values >= 0) & (values < n)].to(torch.int64)
    e, live = values.shape[0], int(valid.sum())
    label = label.format(live=live)
    # a flag per slot, a value per valid slot, a count per bin
    return (label, lambda: kops.segment_counts(values, valid, n),
            lambda: ref.segment_counts(values, valid, n),
            lambda: torch.bincount(counted, minlength=n),
            e + 4 * live + 4 * n, live)


def bloom_case(kops, ref, label, keys, valid, nbits):
    """A ``record_rows`` case of bloom_build (no library call computes it);
    ``{live}`` in ``label`` becomes the count of valid keys."""
    n, live = keys.shape[0], int(valid.sum())
    label = label.format(live=live)
    # a flag per slot, a key per valid slot, an int32 per bit
    return (label, lambda: kops.bloom_build(keys, valid, nbits),
            lambda: ref.bloom_build(keys, valid, nbits), None,
            n + 4 * live + 4 * nbits, 2 * HASH_OPS * live)


def record_segment_calls(torch, kops, ref, rows, path, calls):
    """Check and time segment_counts with CUDA events on the distinct
    operands of the launches recorded on one path (cases of the kernel's
    row); returns the cases, for ``add_device_times``."""
    cases = []
    for label, (values, valid, n) in distinct_calls(torch, calls):
        label = (f"{path} {label}: E={values.shape[0]} ({{live}} valid) "
                 f"into V={n}")
        cases.append(segment_case(torch, kops, ref, label, values, valid, n))
    record_rows(torch, rows, "segment_counts", SEGMENT_SOURCE,
                SEGMENT_REPLACES, cases, device=False)
    return cases


def most(shapes):
    """{shape: "largest" / "most frequent"} of a Counter of shapes."""
    picks = {max(shapes): "largest", shapes.most_common(1)[0][0]:
             "most frequent"}
    if len(picks) == 1:
        picks = {max(shapes): "largest and most frequent"}
    return picks


def record_bloom_calls(torch, kops, ref, rows, calls, where="phases 4-5"):
    """Log the (N, num_bits) of every bloom_build launch ``where`` (the
    paths that made ``calls``), and check and time the kernel with CUDA
    events at the largest and the most frequent; returns the cases, for
    ``add_device_times``."""
    shapes = collections.Counter((args[0].shape[0], args[2])
                                 for _, args in calls)
    log(f"bloom_build launches of {where} by (N, num_bits): "
        f"{sorted(shapes.items())}")
    cases = []
    for shape, which in most(shapes).items():
        keys, valid, nbits = next(args for _, args in calls
                                  if (args[0].shape[0], args[2]) == shape)
        label = (f"{which} of {where} ({shapes[shape]} of "
                 f"{len(calls)} launches): N={shape[0]} ({{live}} valid) "
                 f"bits={nbits}")
        cases.append(bloom_case(kops, ref, label, keys, valid, nbits))
    record_rows(torch, rows, "bloom_build", BLOOM_SOURCE, BLOOM_REPLACES,
                cases, device=False)
    return cases


def bloom_probe_case(kops, ref, label, bits, keys):
    """A ``record_rows`` case of bloom_probe (no library call computes it):
    a key read and a bool written per key, the bitset read once."""
    n, nbits = keys.shape[0], bits.shape[0]
    return (label, lambda: kops.bloom_probe(bits, keys),
            lambda: ref.bloom_probe(bits, keys), None,
            5 * n + 4 * nbits, 2 * HASH_OPS * n)


def prune_case(torch, kops, ref, label, bits, keys):
    """A ``record_rows`` case of bloom_prune_keys against its plain
    version, ``where(ref.bloom_probe(...), keys, NULL_KEY)``: a key read
    and an int32 written per key, the bitset read once."""
    n, nbits = keys.shape[0], bits.shape[0]
    null = torch.tensor(NULL_KEY, dtype=torch.int32, device=keys.device)
    return (label, lambda: kops.bloom_prune_keys(bits, keys),
            lambda: torch.where(ref.bloom_probe(bits, keys), keys, null),
            None, 8 * n + 4 * nbits, 2 * HASH_OPS * n)


def probe_pair(torch, kops, bits, keys):
    """The two calls bloom_prune_keys replaces on the join path:
    ``where(bloom_probe(bits, keys), keys, NULL_KEY)``."""
    null = torch.tensor(NULL_KEY, dtype=torch.int32, device=keys.device)
    return lambda: torch.where(kops.bloom_probe(bits, keys), keys, null)


def record_probe_calls(torch, kops, ref, rows, calls, where="phases 4-5"):
    """Log the (N, num_bits) of every bloom_prune_keys launch ``where``,
    and check and time (CUDA events) at the largest and the most
    frequent, with the bits the path built: bloom_probe, bloom_prune_keys
    beside ``probe_pair`` (``pair_ms``, same run), and bloom_probe at
    N = 1 on the largest's bits (the prologue alone).  Returns
    ``(cases, pairs)`` for ``add_device_times`` / ``add_pair_device_times``.
    """
    shapes = collections.Counter((args[1].shape[0], args[0].shape[0])
                                 for _, args in calls)
    log(f"bloom_probe launches of {where} (bloom_prune_keys) by "
        f"(N, num_bits): {sorted(shapes.items())}")
    cases, pairs = [], []
    for shape, which in most(shapes).items():
        bits, keys = next(args[:2] for _, args in calls
                          if (args[1].shape[0], args[0].shape[0]) == shape)
        label = (f"{which} of {where} ({shapes[shape]} of {len(calls)} "
                 f"launches): N={shape[0]} bits={shape[1]}")
        cases.append(bloom_probe_case(kops, ref, label, bits, keys))
        prune = prune_case(torch, kops, ref, f"bloom_prune_keys, {label}",
                           bits, keys)
        cases.append(prune)
        pairs.append((prune[0], probe_pair(torch, kops, bits, keys)))
        if which.startswith("largest"):
            cases.append(bloom_probe_case(
                kops, ref, f"prologue alone: N=1 bits={shape[1]} (the "
                f"largest's of {where})", bits, keys[:1].clone()))
    row = record_rows(torch, rows, "bloom_probe", BLOOM_SOURCE,
                      PROBE_REPLACES, cases, device=False)
    for label, pair in pairs:
        case = next(c for c in row["cases"] if c["shape"] == label)
        case["pair_ms"] = min(cuda_ms(torch, pair), cuda_ms(torch, pair))
        log(f"  bloom_probe + torch.where [{label}] {case['pair_ms']:.4f} "
            f"ms; bloom_prune_keys / pair {case['ms'] / case['pair_ms']:.3f}")
    return cases, pairs


def record_sorted_probe_calls(torch, kops, ref, rows, calls, where):
    """Log the (P, S) of every sorted_probe launch ``where``, and check and
    time the kernel with CUDA events at the largest and the most frequent
    (cases of the kernel's row); returns the cases, for
    ``add_device_times``."""
    shapes = collections.Counter((args[1].shape[0], args[0].shape[0])
                                 for _, args in calls)
    log(f"sorted_probe launches of {where} by (P, S): "
        f"{sorted(shapes.items())}")
    cases = []
    for shape, which in most(shapes).items():
        sk, pk = next(args for _, args in calls
                      if (args[1].shape[0], args[0].shape[0]) == shape)
        cases.append(probe_case(
            torch, kops, ref, f"{which} of {where} ({shapes[shape]} of "
            f"{len(calls)} launches): P={shape[0]} into S={shape[1]}",
            sk, pk))
    record_rows(torch, rows, "sorted_probe",
                "src/repro_torch/kernels/csrc/sorted_probe.cu",
                "src/repro/kernels/sorted_probe.py:45", cases, device=False)
    return cases


def check_every_call(torch, kops, ref, calls, where):
    """Every recorded launch of the join kernels ``where`` once more, each
    against its plain version on the same operands, exact: sorted_probe
    against the bisection, bloom_build against the plain bitset,
    bloom_prune_keys against ``where(plain bloom_probe, keys, NULL_KEY)``.
    Returns {kernel: launches checked}."""
    checked = {}
    for name, recorded in calls.items():
        for i, (_, args) in enumerate(recorded):
            if name == "sorted_probe":
                got, want = kops.sorted_probe(*args), ref.sorted_probe(*args)
                err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
            elif name == "bloom_build":
                err = max_abs_err(torch, kops.bloom_build(*args),
                                  ref.bloom_build(*args))
            else:
                bits, keys = args[:2]
                null = torch.full_like(keys, NULL_KEY)
                err = max_abs_err(
                    torch, kops.bloom_prune_keys(*args),
                    torch.where(ref.bloom_probe(bits, keys), keys, null))
            assert err == 0, \
                f"{name} launch {i + 1} of {where}: max_abs_err {err}"
        checked[name] = len(recorded)
    log(f"{where}: every launch against its plain version, exact: {checked}")
    return checked


def add_pair_device_times(torch, rows, pairs):
    """``pair_device_ms`` of ``record_probe_calls``' pairs, beside the
    prune cases' ``device_ms``, and their ratio."""
    row = next(r for r in rows if r["name"] == "bloom_probe")
    for label, pair in pairs:
        case = next(c for c in row["cases"] if c["shape"] == label)
        case["pair_device_ms"], _ = device_time(torch, pair,
                                                "bloom_probe_kernel")
        case["device_over_pair"] = case["device_ms"] / case["pair_device_ms"]
        log(f"  bloom_probe + torch.where [{label}] device "
            f"{case['pair_device_ms']:.4f} ms; bloom_prune_keys / pair "
            f"{case['device_over_pair']:.3f}")


def frontier_case(torch, kops, ref, label, args):
    """A ``record_rows`` case of frontier_expand on one operand (no library
    call computes it), bounded by the bytes any kernel must read for it: a
    flag per edge, a source per valid edge, a destination per valid edge
    from the frontier, and the n bytes of the fill.  ``{live}`` and
    ``{reach}`` in ``label`` become those two edge counts."""
    src, _, valid, front, _, n = args
    e, live = src.shape[0], int(valid.sum())
    gather = src.clamp(0, front.shape[0] - 1).to(torch.int64)
    reach = int((valid & front[gather]).sum())
    return (label.format(live=live, reach=reach),
            functools.partial(kops.frontier_expand, *args),
            functools.partial(ref.frontier_expand, *args), None,
            e + 4 * live + 4 * reach + n, e)


def record_frontier_calls(torch, kops, ref, rows, calls):
    """Check and time frontier_expand with CUDA events on each launch
    recorded in k-hop (cases of the kernel's row); returns the cases."""
    cases = []
    for i, (_, args) in enumerate(calls):
        front = int(args[3].sum())
        label = (f"k-hop launch {i + 1} of {len(calls)}: E={args[0].shape[0]}"
                 f" ({{live}} valid, {{reach}} from a frontier of {front}) "
                 f"V={args[5]}")
        cases.append(frontier_case(torch, kops, ref, label, args))
    record_rows(torch, rows, "frontier_expand", FRONTIER_SOURCE,
                FRONTIER_REPLACES, cases, device=False)
    return cases


def check_kernels(torch, kops, ref, tpcds_np):
    """Phase 3: the join kernels against their plain versions, exact, at
    the edge cases and at ``join_cases``, timed with CUDA events (device
    times later: ``add_device_times``)."""
    import numpy as np

    from repro_torch.kernels.sorted_probe import fence_stride

    dev = torch.device("cuda")
    null = np.int32(2**31 - 1)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    zipf = np.sort(np.minimum(rng.zipf(1.3, 1_000_000), 50_000))
    edge_probe = [
        ("empty probe", t(np.arange(100)), t([])),
        # runs of one key (up to ~250k) far longer than the fence stride
        ("duplicate runs > fence stride", t(zipf),
         t(np.concatenate([rng.permutation(zipf)[:100_000], [0, 50_001]]))),
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
        if name.startswith("duplicate runs"):
            run, stride = int((rhi - rlo).max()), fence_stride(sk.shape[0])
            assert run > stride, f"longest run {run} <= stride {stride}"
            log(f"  sorted_probe [{name}]: longest run {run}, fence stride "
                f"{stride}: exact")
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
        hit = ref.bloom_probe(rbits, probe)
        err = max_abs_err(torch, kops.bloom_probe(bits, probe), hit)
        assert err == 0, f"bloom_probe {name}: max_abs_err {err}"
        err = max_abs_err(torch, kops.bloom_prune_keys(bits, probe),
                          torch.where(hit, probe, t(null)))
        assert err == 0, f"bloom_prune_keys {name}: max_abs_err {err}"
    log("edge cases: sorted_probe", len(edge_probe), "bloom",
        len(edge_bloom), "all exact")

    rows = []
    for name, (source, replaces, cases) in join_cases(
            torch, kops, ref, tpcds_np).items():
        record_rows(torch, rows, name, source, replaces, cases, device=False)
    return rows


def join_cases(torch, kops, ref, tpcds_np):
    """Phase 3's timed cases of the join kernels, {name: (source, replaces,
    cases)} in ``record_rows``' form, on the TPC-DS SF1 key columns."""
    import numpy as np

    dev = torch.device("cuda")
    fact_i = torch.from_numpy(tpcds_np["i_sk"]).to(dev)       # 2.88M
    item_sorted = torch.from_numpy(np.sort(tpcds_np["i_id"])).to(dev)
    fact_sorted = torch.sort(fact_i).values

    nbits = kops.bloom_bits_for(fact_i.shape[0])
    valid = torch.ones(fact_i.shape, dtype=torch.bool, device=dev)
    n = fact_i.shape[0]
    bits = ref.bloom_build(item_sorted, torch.ones_like(item_sorted,
                                                        dtype=torch.bool),
                           nbits)
    return {
        "sorted_probe": (
            "src/repro_torch/kernels/csrc/sorted_probe.cu",
            "src/repro/kernels/sorted_probe.py:45",
            [probe_case(torch, kops, ref,
                        f"P={n} into S={fact_sorted.shape[0]}",
                        fact_sorted, fact_i),
             probe_case(torch, kops, ref,
                        f"P={n} into S={item_sorted.shape[0]}",
                        item_sorted, fact_i)]),
        "bloom_build": (
            BLOOM_SOURCE, BLOOM_REPLACES,
            [bloom_case(kops, ref, f"N={n} ({{live}} valid) bits={nbits}",
                        fact_i, valid, nbits)]),
        "bloom_probe": (
            BLOOM_SOURCE, PROBE_REPLACES,
            [bloom_probe_case(kops, ref, f"N={n} bits={nbits}", bits,
                              fact_i)]),
    }


def spmv_compare(torch, src, dst, valid, x, n, stats):
    """``compare`` for edge_spmv: kernel and plain each within
    ``SPMV_BOUND_FACTOR`` x the recursive-summation bound of a float64 sum
    of the same inputs, per vertex; returns max |kernel - plain|."""
    keep = valid & (dst >= 0) & (dst < n)
    d = dst[keep].to(torch.int64)
    xs = x[src[keep].clamp(0, x.shape[0] - 1).to(torch.int64)].double()
    zero = torch.zeros(n, dtype=torch.float64, device=x.device)
    y64 = zero.clone().index_add_(0, d, xs)
    deg = zero.clone().index_add_(0, d, torch.ones_like(xs))
    absum = zero.clone().index_add_(0, d, xs.abs())
    bound = SPMV_BOUND_FACTOR * deg * 2.0**-24 * absum + 1e-30

    def compare(got, want):
        assert got.dtype == want.dtype == torch.float32
        for who, y in (("kernel", got), ("plain", want)):
            ratio = float(((y.double() - y64).abs() / bound).max()) \
                if n else 0.0
            stats[who] = max(stats.get(who, 0.0), ratio)
            assert ratio <= 1.0, f"edge_spmv {who}: error {ratio} x bound"
        return float((got - want).abs().max()) if n else 0.0
    return compare


def record_spmv(torch, kops, ref, rows, label, src, dst, valid, x, n,
                device=True):
    """Check edge_spmv to its bound on one edge list and time it beside
    gather + ``index_add_``, into the kernel's row."""
    keep = valid & (dst >= 0) & (dst < n)
    s64, d64 = src[keep].to(torch.int64), dst[keep].to(torch.int64)
    e = src.shape[0]
    stats = {}
    row = record_rows(
        torch, rows, "edge_spmv", "src/repro_torch/kernels/csrc/spmv.cu",
        "src/repro/kernels/spmv.py:31",
        [(label, lambda: kops.edge_spmv(src, dst, valid, x, n),
          lambda: ref.edge_spmv(src, dst, valid, x, n),
          lambda: torch.zeros(n, device=x.device).index_add_(0, d64, x[s64]),
          9 * e + 8 * n, e)],
        compare=spmv_compare(torch, src, dst, valid, x, n, stats),
        device=device)
    seen = row.setdefault("error_over_bound", {})
    for who, ratio in stats.items():
        seen[who] = max(seen.get(who, 0.0), ratio)
    log(f"  edge_spmv [{label}] error / bound: {stats}")


def record_min_label(torch, kops, ref, rows, label, src, dst, valid, labels,
                     n, device=True):
    """Check edge_min_label exactly on one edge list and labels, and time
    it beside clone + gather + ``scatter_reduce_``, into the kernel's row."""
    keep = valid & (dst >= 0) & (dst < n)
    s64, d64 = src[keep].to(torch.int64), dst[keep].to(torch.int64)
    e = src.shape[0]
    record_rows(
        torch, rows, "edge_min_label",
        "src/repro_torch/kernels/csrc/label_prop.cu",
        "src/repro/kernels/label_prop.py:33",
        [(label, lambda: kops.edge_min_label(src, dst, valid, labels, n),
          lambda: ref.edge_min_label(src, dst, valid, labels, n),
          lambda: labels[:n].clone().scatter_reduce_(0, d64, labels[s64],
                                                     "amin"),
          9 * e + 8 * n, e)], device=device)


def check_scatter_table(torch, kops, ref, n, n_edges):
    """Edge cases aimed at the shared-memory table of edge_spmv and
    edge_min_label, at n vertices and n_edges edges: kernel and plain
    within the spmv bound, min-label exactly equal at the first and second
    step."""
    import numpy as np

    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    _, per_block = _build.scatter_grid(
        n_edges, torch.cuda.get_device_properties(dev).multi_processor_count)
    keys = np.arange(n, dtype=np.int64)
    home = (keys * TABLE_HASH & 0xFFFFFFFF) >> (32 - TABLE_SLOT_BITS)
    colliding = keys[home == home[-1]]
    stride = np.arange(n_edges, dtype=np.int64) * 7919 % n
    cases = [
        ("every edge into one vertex", np.full(n_edges, n - 1)),
        ("more distinct dst in a block's range than table slots", stride),
        (f"{colliding.size} dst of one home slot, past the probe bound",
         rng.choice(colliding, n_edges)),
        ("dst runs longer than a block's range",
         np.arange(n_edges) // (4 * per_block)),
    ]
    assert np.unique(stride[:per_block]).size > 2**TABLE_SLOT_BITS
    assert colliding.size > TABLE_MAX_PROBE

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    src = t(rng.integers(0, n, n_edges), np.int32)
    valid = t(rng.random(n_edges) < 0.95, bool)
    x = t(rng.random(n) / n, np.float32)
    for name, dst_np in cases:
        dst = t(dst_np, np.int32)
        stats = {}
        spmv_compare(torch, src, dst, valid, x, n, stats)(
            kops.edge_spmv(src, dst, valid, x, n),
            ref.edge_spmv(src, dst, valid, x, n))
        labels = t(rng.permutation(n), np.int32)
        for step in (1, 2):
            got = kops.edge_min_label(src, dst, valid, labels, n)
            labels = ref.edge_min_label(src, dst, valid, labels, n)
            assert torch.equal(got, labels), \
                f"edge_min_label [{name}] step {step} != plain"
        log(f"  [{name}]: edge_spmv error / bound {stats}; edge_min_label "
            f"steps 1-2 exact")
    log(f"edge cases: scatter table {len(cases)} at E={n_edges} V={n}, "
        f"{per_block} edges a block")


def check_graph_kernels(torch, kops, ref, csr):
    """Phase 3, graph kernels (at the start of phase 6): each against its
    plain version at the edge cases and at ``oj_graph_specs``, exact, spmv
    to its bound; timed with CUDA events (device times later)."""
    import numpy as np

    dev = csr.device
    rng = np.random.default_rng(1)

    def t(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    # edge cases: empty, all invalid, one vertex with a self-loop and a
    # padding slot, -1 destinations on valid slots
    dst_neg = rng.integers(0, 50, 300)
    dst_neg[rng.random(300) < 0.3] = -1
    edge_cases = [
        ("empty", t([], np.int32), t([], np.int32), t([], bool), 5),
        ("all invalid", t(rng.integers(0, 8, 16), np.int32),
         t(rng.integers(0, 8, 16), np.int32), t(np.zeros(16, bool)), 8),
        ("n=1 self-loop + padding", t([0, 0], np.int32), t([0, 0], np.int32),
         t([True, False]), 1),
        ("dst=-1 slots", t(rng.integers(0, 50, 300), np.int32),
         t(dst_neg, np.int32), t(rng.random(300) < 0.9), 50),
    ]
    for name, s, d, v, n in edge_cases:
        lab = t(rng.permutation(n), np.int32)
        front = t(rng.random(n) < 0.5)
        seen = t(rng.random(n) < 0.3)
        x = t(rng.integers(-4, 5, n), np.float32)   # exact float32 sums
        pairs = [
            (kops.segment_counts(d, v, n), ref.segment_counts(d, v, n)),
            (kops.segment_counts(s, v, n), ref.segment_counts(s, v, n)),
            (kops.edge_spmv(s, d, v, x, n), ref.edge_spmv(s, d, v, x, n)),
            (kops.edge_min_label(s, d, v, lab, n),
             ref.edge_min_label(s, d, v, lab, n)),
            (kops.frontier_expand(s, d, v, front, seen, n),
             ref.frontier_expand(s, d, v, front, seen, n)),
        ]
        for got, want in pairs:
            assert got.dtype == want.dtype and torch.equal(got, want), name
    log("edge cases: graph kernels", len(edge_cases), "all exact")
    check_scatter_table(torch, kops, ref, csr.num_vertices,
                        csr.coo("Buy")[0].shape[0])
    rows = []
    record_specs(torch, kops, ref, rows, oj_graph_specs(torch, ref, csr),
                 device=False)
    return rows


def oj_graph_specs(torch, ref, csr):
    """The graph kernels' timed operands on the JS-OJ CSR: [(kernel,
    label, args)], ``args`` as the kernel's wrapper takes them."""
    import numpy as np

    dev, n = csr.device, csr.num_vertices
    sb, db, vb = csr.coo("Buy")                   # PageRank's label
    sa, da, va = csr.coo()                        # k-hop, degree stats
    ss, ds, vs = csr.coo(symmetric=True)          # WCC
    e_b, e_a, e_s = sb.shape[0], sa.shape[0], ss.shape[0]
    x = torch.from_numpy(np.random.default_rng(1).random(n).astype(
        np.float32) / n).to(dev)
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[:KHOP_SEEDS] = True
    label = f"E={e_s} (symmetric) V={n}"
    return [
        ("segment_counts", f"Buy sources, CSR order: E={e_b} "
         f"({int(vb.sum())} valid) into V={n}", (sb, vb, n)),
        ("edge_spmv", f"E={e_b} V={n}", (sb, db, vb, x, n)),
        ("edge_min_label", label, (ss, ds, vs, lab, n)),
        # the labels WCC's second to last launches see
        ("edge_min_label", f"{label}, labels after one step",
         (ss, ds, vs, ref.edge_min_label(ss, ds, vs, lab, n), n)),
        ("frontier_expand", f"E={e_a} V={n} frontier={KHOP_SEEDS}",
         (sa, da, va, front, front.clone(), n)),
    ]


def mv_graph_specs(torch, ref, csr):
    """``oj_graph_specs`` on the JS-MV CSR: edge_spmv on PageRank's edges,
    edge_min_label on WCC's (first step and second)."""
    import numpy as np

    dev, n = csr.device, csr.num_vertices
    src, dst, valid = csr.coo()                   # PageRank's edges
    x = torch.from_numpy(np.random.default_rng(7).random(n).astype(
        np.float32) / n).to(dev)
    ss, ds, vs = csr.coo(symmetric=True)          # WCC's edges
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    label = f"JS-MV E={ss.shape[0]} (symmetric) V={n}"
    return [
        ("edge_spmv", f"JS-MV E={src.shape[0]} V={n}",
         (src, dst, valid, x, n)),
        ("edge_min_label", label, (ss, ds, vs, lab, n)),
        ("edge_min_label", f"{label}, labels after one step",
         (ss, ds, vs, ref.edge_min_label(ss, ds, vs, lab, n), n)),
    ]


def record_specs(torch, kops, ref, rows, specs, device):
    """Check and time each (kernel, label, args) of ``specs`` into
    ``rows`` (``record_rows``; ``device`` as there)."""
    for kernel, label, args in specs:
        if kernel == "segment_counts":
            record_rows(torch, rows, kernel, SEGMENT_SOURCE,
                        SEGMENT_REPLACES,
                        [segment_case(torch, kops, ref, label, *args)],
                        device=device)
        elif kernel == "edge_spmv":
            record_spmv(torch, kops, ref, rows, label, *args, device=device)
        elif kernel == "edge_min_label":
            record_min_label(torch, kops, ref, rows, label, *args,
                             device=device)
        else:
            record_rows(torch, rows, kernel, FRONTIER_SOURCE,
                        FRONTIER_REPLACES,
                        [frontier_case(torch, kops, ref, label, args)],
                        device=device)


def add_spec_device_times(torch, kops, rows, specs):
    """``add_device_times`` for the cases ``record_specs(..., device=False)``
    recorded, on ``specs`` rebuilt alike."""
    for kernel, label, args in specs:
        add_device_times(torch, rows, kernel, [
            (label, functools.partial(getattr(kops, kernel), *args))])


def digest_s(graph) -> float:
    """Seconds of one content digest of ``graph``'s tables (what every
    ``analyze`` pays to look its CSR up), on a fresh, unmemoized copy."""
    from repro_torch.core.extract import ExtractedGraph

    fresh = ExtractedGraph(vertices=dict(graph.vertices),
                           edges=dict(graph.edges))
    t0 = time.perf_counter()
    fp = fresh.fingerprint()
    seconds = time.perf_counter() - t0
    assert fp == graph.fingerprint()
    return seconds


def pagerank_error(got, want) -> dict:
    """L1 distance and max relative error of one rank vector to another."""
    diff = (got.double() - want.double()).abs()
    return {"l1": float(diff.sum()),
            "max_rel": float((diff / want.double().abs()).max())}


def pagerank_tolerance(ref, csr, label=None) -> float:
    """``D_max * 2**-24``: the relative recursive-summation bound of one
    float32 sum over the largest in-degree of the edges PageRank runs on."""
    _, dst, valid = csr.coo(label)
    d_max = int(ref.segment_counts(dst.clamp_min(0), valid,
                                   csr.num_vertices).max())
    return d_max * 2.0**-24


def check_pagerank(err: dict, tol: float, what: str) -> None:
    err["tolerance"] = tol
    assert err["l1"] <= tol and err["max_rel"] <= tol, \
        f"{what}: {err} beyond L1 / max_rel {tol}"


def replay(torch, kops, names, counts, fn):
    """Run ``fn`` (a path) once more, untimed, with the wrappers ``names``
    recorded: (its result, {name: recorded calls}).  The replay must launch
    every kernel as often as the timed run whose ``counts`` are given, so
    the recorded operands are the ones that run's launches saw."""
    kops.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        calls = {n: stack.enter_context(recording(kops, n)) for n in names}
        out = fn()
        torch.cuda.synchronize()
    again = kops.launch_counts()
    assert again == counts, f"replay launched {again}, the timed run {counts}"
    return out, calls


def extract_twice(engine, model):
    """The extraction paths (phases 4-5): a cold request, then a warm one."""
    return engine.extract(model), engine.extract(model)


def drive(torch, kops, engine, model, label):
    """Cold then warm extract between a counter reset and a counter read."""
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    cold, warm = extract_twice(engine, model)
    counts = kops.launch_counts()
    missing = [k for k in JOIN_KERNELS if counts[k] == 0]
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


def analyze_oj(kops, engine, model):
    """Phase 6's requests: PageRank on Buy cold then warm, WCC, k-hop and
    degree statistics; also the launches WCC took."""
    import numpy as np

    cold = engine.analyze(model, algorithm="pagerank", label="Buy",
                          iters=PR_ITERS)
    warm = engine.analyze(model, algorithm="pagerank", label="Buy",
                          iters=PR_ITERS)
    before = kops.launch_counts()["edge_min_label"]
    wcc = engine.analyze(model, algorithm="wcc")
    wcc_iters = kops.launch_counts()["edge_min_label"] - before
    khop = engine.analyze(model, algorithm="khop",
                          seeds=np.arange(KHOP_SEEDS), k=KHOP_K)
    deg = engine.analyze(model, algorithm="degree_stats")
    return cold, warm, wcc, khop, deg, wcc_iters


def analyze_mv(engine, model):
    """Phase 7's requests: PageRank, then WCC."""
    return (engine.analyze(model, algorithm="pagerank", iters=PR_ITERS),
            engine.analyze(model, algorithm="wcc"))


def analytics_oj(torch, kops, ref, ExtractionEngine, db, model, graph):
    """Phase 6: the graph kernels checked and timed with CUDA events
    (their rows, device times later), then engine.analyze on the JS-OJ
    graph, timed, against numpy and the plain CSR build."""
    import numpy as np

    from repro_torch.graph import algorithms as talg
    from repro_torch.graph import build_csr
    from repro_torch.graph import reference as gref

    t0 = time.perf_counter()
    plain_csr = build_csr(graph, model, use_kernel=False)
    torch.cuda.synchronize()
    log(f"JS-OJ graph: plain CSR build {time.perf_counter() - t0:.4f} s, "
        f"V={plain_csr.num_vertices} E={plain_csr.edge_counts}")
    log("graph kernels vs plain, CUDA-event times:")
    rows = check_graph_kernels(torch, kops, ref, plain_csr)

    engine = ExtractionEngine(db)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    cold, warm, wcc, khop, deg, wcc_iters = analyze_oj(kops, engine, model)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in GRAPH_KERNELS if counts[k] == 0]
    assert not missing, f"JS-OJ analytics: kernels never launched: {missing}"
    assert not cold.provenance.csr_cache_hit
    assert warm.provenance.csr_cache_hit, "warm analyze rebuilt the CSR"
    assert warm.provenance.extraction.plan_cache_hit
    for r in (wcc, khop, deg):
        assert r.provenance.csr_cache_hit and r.csr is cold.csr

    csr = cold.csr
    assert csr.num_vertices == plain_csr.num_vertices
    same = [torch.equal(csr.vertex_ids, plain_csr.vertex_ids)]
    for field in ("offsets", "targets", "sources"):
        got, want = getattr(csr, field), getattr(plain_csr, field)
        same += [set(got) == set(want)]
        same += [torch.equal(got[k], want[k]) for k in want]
    assert all(same), "kernel-built CSR != plain build"

    n = csr.num_vertices
    sb, db, vb = [a.cpu().numpy() for a in csr.coo("Buy")]
    sa, da, va = [a.cpu().numpy() for a in csr.coo()]
    t0 = time.perf_counter()
    pr_np = gref.pagerank_np(sb, db, vb, n, iters=PR_ITERS)
    wcc_np = gref.wcc_np(sa, da, va, n)
    seeds = np.zeros(n, bool)
    seeds[:KHOP_SEEDS] = True
    khop_np = gref.khop_np(sa, da, va, seeds, n, k=KHOP_K)
    deg_np = gref.degree_stats_np(sa, da, va, n)
    numpy_s = time.perf_counter() - t0
    pr_tol = pagerank_tolerance(ref, csr, "Buy")
    pr_truth = torch.from_numpy(pr_np).to(csr.device)
    pr_err = pagerank_error(warm.values, pr_truth)
    check_pagerank(pr_err, pr_tol, "JS-OJ PageRank (kernels) vs numpy")
    plain_pr = talg.pagerank(csr, label="Buy", iters=PR_ITERS,
                             use_kernel=False)
    plain_err = pagerank_error(plain_pr, pr_truth)
    check_pagerank(plain_err, pr_tol, "JS-OJ PageRank (plain) vs numpy")
    assert np.array_equal(wcc.values.cpu().numpy(), wcc_np), "WCC != numpy"
    assert np.array_equal(khop.values.cpu().numpy(), khop_np), "k-hop != numpy"
    for key in ("out_degree", "in_degree"):
        assert np.array_equal(deg.values[key].cpu().numpy(), deg_np[key]), key
    for key in ("num_edges", "max_out_degree", "max_in_degree", "isolated"):
        assert int(deg.values[key]) == deg_np[key], key
    # float32 quotient against numpy's float64 one
    assert abs(float(deg.values["mean_degree"]) - deg_np["mean_degree"]) \
        <= 1e-6 * deg_np["mean_degree"]

    timing = {
        "V": n, "E": int(sum(csr.edge_counts.values())),
        "csr_build_s_cold": cold.timings.csr_build_s,
        "csr_build_s_warm": warm.timings.csr_build_s,
        "extract_s_cold": cold.timings.extract_s,
        "extract_s_warm": warm.timings.extract_s,
        "analyze_s": {"pagerank_cold": cold.timings.analyze_s,
                      "pagerank_warm": warm.timings.analyze_s,
                      "wcc": wcc.timings.analyze_s,
                      "khop": khop.timings.analyze_s,
                      "degree_stats": deg.timings.analyze_s},
        "graph_digest_s": digest_s(cold.extraction.graph),
        "wcc_iterations": wcc_iters, "pagerank_vs_numpy": pr_err,
        "plain_pagerank_vs_numpy": plain_err,
        "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    log(f"JS-OJ analytics: {json.dumps(timing)}")
    log(f"  WCC components {len(np.unique(wcc_np))}, k-hop reached "
        f"{int((khop_np >= 0).sum())}; CSR (kernel) == plain build; "
        f"WCC, k-hop, degrees == numpy (numpy took {numpy_s:.2f} s); "
        f"PageRank L1 {pr_err['l1']:.3e} (plain {plain_err['l1']:.3e}), "
        f"max_rel {pr_err['max_rel']:.3e} (plain {plain_err['max_rel']:.3e})"
        f" <= {pr_tol:.3e}")
    return rows, counts, timing


def analytics_mv(torch, kops, ref, ExtractionEngine, db, model, rows):
    """Phase 7: PageRank and WCC on the JS-MV graph, timed, kernels vs the
    plain path on the same CSR; then edge_spmv and edge_min_label checked
    and timed with CUDA events on its edge lists (cases added to their
    ``rows``, device times later)."""
    from repro_torch.graph import algorithms as talg

    engine = ExtractionEngine(db)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    pr, wcc = analyze_mv(engine, model)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in ("segment_counts", "edge_spmv", "edge_min_label")
               if counts[k] == 0]
    assert not missing, f"JS-MV analytics: kernels never launched: {missing}"
    assert wcc.provenance.csr_cache_hit

    csr = pr.csr
    t0 = time.perf_counter()
    plain_pr = talg.pagerank(csr, iters=PR_ITERS, use_kernel=False)
    torch.cuda.synchronize()
    plain_pr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_wcc = talg.wcc(csr, use_kernel=False)
    torch.cuda.synchronize()
    plain_wcc_s = time.perf_counter() - t0
    assert torch.equal(wcc.values, plain_wcc), "JS-MV WCC != plain path"
    pr_err = pagerank_error(pr.values, plain_pr)
    check_pagerank(pr_err, pagerank_tolerance(ref, csr),
                   "JS-MV PageRank vs plain path")
    timing = {
        "V": csr.num_vertices, "E": int(sum(csr.edge_counts.values())),
        "csr_build_s_cold": pr.timings.csr_build_s,
        "csr_build_s_warm": wcc.timings.csr_build_s,
        "graph_digest_s": digest_s(pr.extraction.graph),
        "extract_s_cold": pr.timings.extract_s,
        "extract_s_warm": wcc.timings.extract_s,
        "analyze_s": {"pagerank": pr.timings.analyze_s,
                      "wcc": wcc.timings.analyze_s,
                      "pagerank_plain": plain_pr_s,
                      "wcc_plain": plain_wcc_s},
        "pagerank_vs_plain": pr_err,
        "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    log(f"JS-MV analytics: {json.dumps(timing)}")
    log(f"  WCC == plain path; PageRank L1 {pr_err['l1']:.3e}, max_rel "
        f"{pr_err['max_rel']:.3e} <= {pr_err['tolerance']:.3e}")
    log("JS-MV graph kernels vs plain, CUDA-event times:")
    record_specs(torch, kops, ref, rows, mv_graph_specs(torch, ref, csr),
                 device=False)
    return counts, timing


def attended_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(i, j) pairs the flash kernel's masks keep: j < sk, i >= j when
    causal, i - j < window."""
    import numpy as np

    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_compare(torch):
    """``compare`` for flash_attention: bf16 outputs within rtol = atol =
    FLASH_TOL of the plain version; returns max |kernel - plain|."""
    def compare(got, want):
        assert got.dtype == want.dtype == torch.bfloat16
        assert got.shape == want.shape
        assert bool(torch.isfinite(got.float()).all()), "non-finite output"
        diff = (got.float() - want.float()).abs()
        bad = diff > FLASH_TOL + FLASH_TOL * want.float().abs()
        assert not bool(bad.any()), \
            f"flash_attention: {int(bad.sum())} outputs beyond {FLASH_TOL}"
        return float(diff.max()) if diff.numel() else 0.0
    return compare


FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:32"


def flash_qkv(torch, gen, b, sq, sk, hq, hkv, dh):
    """Random bf16 (B, S, H, Dh) q, k, v on the card from ``gen``."""
    dev = torch.device("cuda")
    return [torch.randn((b, s, h, dh), generator=gen, device=dev)
            .to(torch.bfloat16) for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


def check_flash_kernel(torch, kops, ref):
    """Phase 8a: flash_attention against its plain version in bf16, at the
    edge cases and at ``flash_cases`` (timed with CUDA events; device times
    later: ``add_device_times``)."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(8)
    compare = flash_compare(torch)
    edge = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal, window)
        ("S 1", (1, 1, 1, 2, 1, 64), True, None),
        ("S 200, Dh 32", (2, 200, 200, 4, 2, 32), True, None),
        ("non-causal", (1, 256, 256, 4, 2, 128), False, None),
        ("window 64, Dh 16", (1, 300, 300, 4, 4, 16), True, 64),
        ("MQA, S 333", (1, 333, 333, 8, 1, 64), True, None),
        ("Sk > Sq", (1, 64, 300, 2, 1, 64), False, None),
        ("S 200, Dh 120, window 64", (1, 200, 200, 4, 2, 120), True, 64),
        # 32 key tiles of 128: the K/V ring of shared memory wraps many times
        ("ring wrap, S 4096, Dh 128", (1, 4096, 4096, 2, 1, 128), True, None),
    ]
    for name, shape, causal, window in edge:
        q, k, v = flash_qkv(torch, gen, *shape)
        compare(kops.flash_attention(q, k, v, causal=causal, window=window),
                ref.flash_attention(q, k, v, causal=causal, window=window))
    log(f"edge cases: flash_attention {len(edge)} within {FLASH_TOL}")
    rows = []
    record_rows(torch, rows, "flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                flash_cases(torch, kops, ref), compare=compare, device=False)
    torch.cuda.empty_cache()
    return rows


def flash_cases(torch, kops, ref):
    """The LM path's flash_attention shapes in ``record_rows``' form, on
    inputs from one seeded generator (the same on every call)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def case(label, b, s, hq, hkv, dh, window):
        q, k, v = flash_qkv(torch, gen, b, s, s, hq, hkv, dh)
        # the library yardstick: (B, H, S, Dh) copies with K/V expanded to
        # Hq heads, prepared outside the timing; a window needs a mask
        qt, kt, vt = (x.transpose(1, 2).repeat_interleave(hq // x.shape[2],
                                                          dim=1).contiguous()
                      for x in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)

        def library():
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        pairs = attended_pairs(s, s, True, window)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        return (label,
                lambda: kops.flash_attention(q, k, v, window=window),
                lambda: ref.flash_attention(q, k, v, window=window),
                library, nbytes, 4 * b * hq * dh * pairs, BF16_FLOPS_PER_S)

    return [case(f"{LM_ARCH} prefill B 4 S 2048 16/2 Dh 128 causal",
                 4, 2048, 16, 2, 128, None),
            case("gemma-2b B 1 S 2048 8/1 Dh 256 causal",
                 1, 2048, 8, 1, 256, None),
            case("h2o-danube-3-4b B 1 S 8192 32/8 Dh 120 window 4096",
                 1, 8192, 32, 8, 120, 4096)]


def serve_lm(torch, kops):
    """Phase 8b: qwen2.5-3b at full width: prefill + greedy decode through
    the flash kernel, then the plain attention path on the same inputs."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"LM: {cfg.name} layers {cfg.num_layers} d_model {cfg.d_model} "
        f"vocab {cfg.vocab_size}: {n_params} parameters (bf16 weights) in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    max_len = LM_PROMPT + LM_STEPS

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    (logits, cache), prefill_s = timed(
        lambda: prefill(params, cfg, batch, max_len))
    prefill_launches = kops.launch_counts()["flash_attention"]
    first_logits = logits
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_logits = []

    def decode():
        nonlocal cache, tok
        for _ in range(LM_STEPS):
            out, cache = decode_step(params, cfg, cache, tok)
            step_logits.append(out)
            tok = torch.argmax(out, dim=-1).to(torch.int32)

    _, decode_s = timed(decode)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert prefill_launches == cfg.num_layers, \
        f"flash_attention launched {prefill_launches} times in the prefill"
    assert counts["flash_attention"] == cfg.num_layers, \
        "decode steps launched the flash kernel"
    for out in [first_logits] + step_logits:
        assert out.shape == (LM_BATCH, cfg.vocab_size)
        assert out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()), "non-finite logits"
    assert int(cache["pos"]) == LM_PROMPT + LM_STEPS
    first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)
    first_step = step_logits[0]
    del cache

    # the same prefill and first decode step on the plain attention path
    (plain_logits, plain_cache), plain_prefill_s = timed(
        lambda: prefill(params, cfg, batch, max_len, use_kernel=False))
    plain_step, _ = decode_step(params, cfg, plain_cache, first_tok)
    del plain_cache
    _, warm_prefill_s = timed(lambda: prefill(params, cfg, batch, max_len))
    agree = {}
    for what, got, want in (("prefill", first_logits, plain_logits),
                            ("step 1", first_step, plain_step)):
        rel = float((got - want).abs().max() / want.std())
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        agree[what] = {"max_abs_over_std": rel, "argmax_agreement": same}
        assert rel <= LM_REL_TOL, \
            f"LM {what}: kernel vs plain {rel:.4f} x std > {LM_REL_TOL}"
    timing = {
        "arch": cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "decode_steps": LM_STEPS, "prefill_s": prefill_s,
        "prefill_s_warm": warm_prefill_s,
        "plain_prefill_s": plain_prefill_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_ms_per_step": decode_s / LM_STEPS * 1e3,
        "decode_tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
        "max_memory_allocated_gib": peak / 2**30,
        "kernel_vs_plain": agree, "launches": counts}
    log(f"LM serve: {json.dumps(timing)}")
    return counts, timing


@contextlib.contextmanager
def fold_timer():
    """Sums the seconds of the engine's host fold (``apply_table_delta``,
    edges and views) while it is active; ``{"s": seconds, "calls": n}``."""
    import repro_torch.api.engine as eng

    fold = eng.apply_table_delta
    acc = {"s": 0.0, "calls": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fold(*args, **kwargs)
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    eng.apply_table_delta = timed
    try:
        yield acc
    finally:
        eng.apply_table_delta = fold


def graph_digests(graph) -> dict:
    """Every vertex and edge table's bag digest."""
    return {"vertices": digests(graph.vertices), "edges": digests(graph.edges)}


def fresh_graph(ExtractionEngine, Database, db, model):
    """A from-scratch extraction over ``db``'s current tables on the plain
    path: a new database (exact ANALYZE) and a new engine whose compiler
    launches no kernel, so no kernel's fault can reach the reference."""
    from repro_torch.core.pipeline import PipelineCompiler

    engine = ExtractionEngine(Database(dict(db.tables)),
                              compiler=PipelineCompiler(use_kernel=False,
                                                        use_bloom=False))
    return engine, engine.extract(model)


def check_coo(torch, got, want, what):
    """Every edge label's live (src, dst) multiset of CSR ``got`` equal to
    ``want``'s, on the same vertex numbering; {label: live edges}."""
    assert got.num_vertices == want.num_vertices and torch.equal(
        got.vertex_ids, want.vertex_ids), f"{what}: vertices differ"
    assert sorted(got.targets) == sorted(want.targets), what
    n, live = got.num_vertices, {}
    for label in sorted(want.targets):
        bags = []
        for csr in (got, want):
            src, dst, valid = csr.coo(label)
            bags.append(torch.sort(src[valid].to(torch.int64) * n
                                   + dst[valid].to(torch.int64)).values)
        assert torch.equal(*bags), f"{what}: {label} edges differ"
        live[label] = bags[0].numel()
    return live


def churn_sales(db, rng, n_ins, n_del):
    """Insert ``n_ins`` store_sales rows (new rids, foreign keys drawn over
    the dimensions) and delete ``n_del`` live rows by slot."""
    import numpy as np

    if n_ins:
        n = int(db.tables["store_sales"]["rid"].max()) + 1
        draw = {c: db.stats[t].rows for c, t in (
            ("c_sk", "customer"), ("i_sk", "item"), ("p_sk", "promotion"),
            ("o_sk", "outlet_store"))}
        db.insert_rows("store_sales",
                       rid=np.arange(n, n + n_ins, dtype=np.int32),
                       **{c: rng.integers(0, k, n_ins).astype(np.int32)
                          for c, k in draw.items()})
    if n_del:
        live = np.flatnonzero(db.tables["store_sales"].valid.cpu().numpy())
        db.delete_rows("store_sales", rng.choice(live, n_del, replace=False))


def mutate_oj(db, rng, rnd):
    """Phase 9(a)'s churn before delta round ``rnd``: 1, store_sales rows
    in and out; 2, new items that no sale references."""
    import numpy as np

    if rnd == 1:
        churn_sales(db, rng, REFRESH_INSERT, REFRESH_DELETE)
        return
    n_item = int(db.tables["item"]["rid"].max()) + 1
    ids = np.arange(n_item, n_item + ITEM_INSERT, dtype=np.int32)
    db.insert_rows("item", rid=ids, i_id=ids,
                   i_price=rng.integers(1, 100, ITEM_INSERT).astype(np.int32))


def mutate_mv(db, rng):
    """Phase 9(b)'s churn: wrote rows in and out."""
    import numpy as np

    n = int(db.tables["wrote"]["rid"].max()) + 1
    db.insert_rows(
        "wrote", rid=np.arange(n, n + MV_INSERT, dtype=np.int32),
        a_sk=rng.integers(0, db.stats["author"].rows,
                          MV_INSERT).astype(np.int32),
        p_sk=rng.integers(0, db.stats["paper"].rows,
                          MV_INSERT).astype(np.int32))
    live = np.flatnonzero(db.tables["wrote"].valid.cpu().numpy())
    db.delete_rows("wrote", rng.choice(live, MV_DELETE, replace=False))


def analyze_patched(engine, model):
    """Phase 9(a)'s requests on the patched CSR after round 1: PageRank on
    Buy, then WCC, each after a refresh that must be a noop."""
    return (engine.analyze(model, algorithm="pagerank", label="Buy",
                           iters=PR_ITERS, auto_refresh=True),
            engine.analyze(model, algorithm="wcc", auto_refresh=True))


def refresh_round(torch, kops, engine, model, expect, label):
    """One ``engine.refresh`` between a counter reset and a counter read,
    timed on the host clock ending in a device sync; the path must be
    ``expect``.  Returns (result, launches, record)."""
    from repro_torch import obs

    terms0 = obs.REGISTRY.value("delta_terms_total")
    with fold_timer() as fold:
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        res = engine.refresh(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
    rp = res.refresh
    assert rp.path == expect, f"{label}: path {rp.path}, expected {expect}"
    record = {"path": rp.path, "churn": rp.churn,
              "rows_changed": rp.rows_changed,
              "tables_changed": list(rp.tables_changed),
              "views_maintained": list(rp.views_maintained),
              "csr_patched": rp.csr_patched,
              "extract_s": res.timings.extract_s, "refresh_s": wall,
              "fold_s": fold["s"], "fold_calls": fold["calls"],
              "delta_terms": obs.REGISTRY.value("delta_terms_total") - terms0,
              "launches": {k: v for k, v in counts.items() if v}}
    if rp.path == "delta":
        missing = [k for k in JOIN_KERNELS if counts[k] == 0]
        assert not missing, f"{label}: kernels never launched: {missing}"
    return res, counts, record


def check_fresh(ExtractionEngine, Database, db, model, res, label):
    """The refreshed graph's digests against a from-scratch extraction;
    returns the fresh engine (its CSR cache is cold)."""
    engine, fresh = fresh_graph(ExtractionEngine, Database, db, model)
    got, want = graph_digests(res.graph), graph_digests(fresh.graph)
    assert got == want, f"{label}: refreshed digests {got} != fresh {want}"
    return engine


def refresh_oj(torch, kops, ref, ExtractionEngine, Database, wal_dir):
    """Phase 9(a) and (c): JS-OJ refresh rounds on a database with a WAL in
    ``wal_dir``, then recovery.  Returns (launches summed over the rounds,
    the launches of rounds 1 and 2, record)."""
    import numpy as np

    from repro_torch.data import fraud_model, make_tpcds
    from repro_torch.durability import (load_manifest, recover_database,
                                        replay_wal, restore_database,
                                        write_manifest)
    from repro_torch.relational.ops import table_digest

    model = fraud_model("store")
    db = make_tpcds(sf=TPCDS_SF)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ExtractionEngine(db)
    cold, warm = extract_twice(engine, model)
    engine.analyze(model, algorithm="pagerank", label="Buy", iters=PR_ITERS)
    assert len(engine._csrs) == 1
    db.attach_wal(str(wal_dir))
    rng = np.random.default_rng(OJ_SEED)
    rounds, total, delta_counts = {}, collections.Counter(), []

    # round 1: 1% in, 0.5% out: the delta path, the cached CSR patched
    mutate_oj(db, rng, 1)
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-OJ round 1")
    assert rec["csr_patched"], "JS-OJ round 1 did not patch the CSR"
    total.update(counts)
    delta_counts.append(counts)
    fresh_engine = check_fresh(ExtractionEngine, Database, db, model, res,
                               "JS-OJ round 1")
    pr, wcc = analyze_patched(engine, model)
    assert pr.extraction.refresh.path == "noop"
    assert pr.provenance.csr_cache_hit, "the patched CSR did not serve"
    assert wcc.provenance.csr_cache_hit
    # the reference: a CSR built from the fresh extraction, and PageRank
    # and WCC on it, all on the plain path
    want = fresh_engine.analyze(model, algorithm="pagerank", label="Buy",
                                iters=PR_ITERS, use_kernel=False)
    rec["patched_live_edges"] = check_coo(
        torch, pr.csr, want.csr, "the patched CSR vs a fresh build")
    err = pagerank_error(pr.values, want.values)
    check_pagerank(err, pagerank_tolerance(ref, want.csr, "Buy"),
                   "PageRank on the patched CSR vs a fresh build")
    assert torch.equal(wcc.values, fresh_engine.analyze(
        model, algorithm="wcc", use_kernel=False).values), \
        "WCC on the patched CSR != fresh"
    rec["patched_labels_dirty"] = sorted(pr.csr.dirty)
    rec["pagerank_vs_fresh"] = err
    rounds["1_delta_csr_patched"] = rec
    del fresh_engine, want, pr, wcc

    # round 2: new items, no sale references them: the vertex set changes
    mutate_oj(db, rng, 2)
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-OJ round 2")
    assert not rec["csr_patched"], "round 2 changed the vertex set"
    total.update(counts)
    delta_counts.append(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 2")
    rounds["2_delta_vertices"] = rec
    t0 = time.perf_counter()
    write_manifest(str(wal_dir), db, {}, {"fraud": res.graph.fingerprint()})
    manifest_s = time.perf_counter() - t0

    # round 3: 15% out (or more, so that churn > threshold): the full path
    base = sum(db.stats[t].rows for t in
               {r.table for q in model.queries() for r in q.relations})
    n_del = max(FULL_DELETE, base // 11 + 1)
    churn_sales(db, rng, 0, n_del)
    res, counts, rec = refresh_round(torch, kops, engine, model, "full",
                                     "JS-OJ round 3")
    assert rec["churn"] > engine.refresh_threshold
    rec["deleted"] = n_del
    total.update(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 3")
    rounds["3_full"] = rec

    # round 4: nothing changed: noop
    res, counts, rec = refresh_round(torch, kops, engine, model, "noop",
                                     "JS-OJ round 4")
    total.update(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 4")
    rounds["4_noop"] = rec
    peak = torch.cuda.max_memory_allocated()
    final_fp = res.graph.fingerprint()

    # (c) crash: the WAL abandoned; recover from the manifest + its tail
    db.detach_wal()
    t0 = time.perf_counter()
    recovered, report = recover_database(str(wal_dir), Database(),
                                         device=db.device)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    assert report.path == "checkpoint" and report.replayed_records == 1
    assert recovered.epoch == db.epoch
    assert recovered.fingerprint() == db.fingerprint(), "stats differ"
    for t in db.tables:
        assert recovered.tables[t].capacity == db.tables[t].capacity, t
        assert table_digest(recovered.tables[t]) == \
            table_digest(db.tables[t]), f"recovered {t} differs"
    got = ExtractionEngine(recovered).extract(model).graph.fingerprint()
    assert got == final_fp, "the recovered database extracts another graph"
    t0 = time.perf_counter()
    again = restore_database(str(wal_dir), load_manifest(str(wal_dir)),
                             device=db.device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay_wal(again, str(wal_dir))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    assert again.fingerprint() == db.fingerprint()
    wal_bytes = sum(f.stat().st_size for f in wal_dir.iterdir())
    record = {"extract_s_cold": cold.timings.extract_s,
              "extract_s_warm": warm.timings.extract_s, "rounds": rounds,
              "max_memory_allocated_gib": peak / 2**30,
              "durability": {"manifest_s": manifest_s,
                             "recovery_s": recovery_s,
                             "restore_s": restore_s, "replay_s": replay_s,
                             "report": report.summary(),
                             "dir_bytes": wal_bytes}}
    log(f"JS-OJ refresh: {json.dumps(record)}")
    log("  every round's digests == a plain-path fresh extract; the patched "
        "CSR's edges, PageRank and WCC == a fresh plain build's; recovered "
        "fingerprint, digests and graph == the live database's")
    return dict(total), delta_counts, record


def refresh_mv(torch, kops, ExtractionEngine, Database):
    """Phase 9(b): one JS-MV refresh through the maintained view."""
    import numpy as np

    from repro_torch.data import dblp_model, make_dblp

    model = dblp_model()
    db = make_dblp(scale=DBLP_SCALE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ExtractionEngine(db)
    cold, warm = extract_twice(engine, model)
    assert cold.provenance.views_built
    mutate_mv(db, np.random.default_rng(MV_SEED))
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-MV")
    assert list(cold.provenance.views_built) == rec["views_maintained"], \
        f"JS-MV maintained {rec['views_maintained']}"
    peak = torch.cuda.max_memory_allocated()
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-MV")
    record = {"extract_s_cold": cold.timings.extract_s,
              "extract_s_warm": warm.timings.extract_s, "round": rec,
              "max_memory_allocated_gib": peak / 2**30}
    log(f"JS-MV refresh: {json.dumps(record)}")
    log("  digests == a plain-path fresh extract")
    return counts, record


def refresh_and_recovery(torch, kops, ref, ExtractionEngine):
    """Phase 9: refresh rounds on JS-OJ (a) and JS-MV (b), and the WAL and
    its recovery on JS-OJ's database (c).  Returns the launches of each
    path's refreshes, and of JS-OJ's two delta rounds one by one."""
    import shutil
    import tempfile

    from repro_torch.core.database import Database

    wal_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_wal_"))
    try:
        counts_oj, delta_counts, _ = refresh_oj(
            torch, kops, ref, ExtractionEngine, Database, wal_dir)
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    counts_mv, _ = refresh_mv(torch, kops, ExtractionEngine, Database)
    torch.cuda.empty_cache()
    return counts_oj, counts_mv, delta_counts


def replay_refresh(torch, kops, ExtractionEngine, counts_oj, counts_mv):
    """Phase 9's delta refreshes once more, untimed, on regenerated data
    with the same seeded churn and the same requests between them, the
    join wrappers recorded (``replay``: each refresh must launch every
    kernel as often as its timed run).  {"JS-OJ" / "JS-MV": {name: calls}}.
    """
    import numpy as np

    from repro_torch.data import dblp_model, fraud_model, make_dblp, make_tpcds

    names = ("sorted_probe", "bloom_build", "bloom_prune_keys")
    out = {"JS-OJ": collections.defaultdict(list)}
    model = fraud_model("store")
    db = make_tpcds(sf=TPCDS_SF)
    engine = ExtractionEngine(db)
    extract_twice(engine, model)
    engine.analyze(model, algorithm="pagerank", label="Buy", iters=PR_ITERS)
    rng = np.random.default_rng(OJ_SEED)
    for rnd, counts in enumerate(counts_oj, 1):
        mutate_oj(db, rng, rnd)
        _, calls = replay(torch, kops, names, counts,
                          lambda: engine.refresh(model))
        for name, recorded in calls.items():
            out["JS-OJ"][name] += recorded
        if rnd == 1:
            analyze_patched(engine, model)
    del engine, db
    model = dblp_model()
    db = make_dblp(scale=DBLP_SCALE)
    engine = ExtractionEngine(db)
    extract_twice(engine, model)
    mutate_mv(db, np.random.default_rng(MV_SEED))
    _, out["JS-MV"] = replay(torch, kops, names, counts_mv,
                             lambda: engine.refresh(model))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def digests(edges):
    from repro_torch.relational.ops import table_digest

    return {lab: table_digest(t) for lab, t in edges.items()}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args(argv)

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
    from repro_torch.graph import build_csr
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.relational import Table
    from repro_torch.relational.ops import table_digest

    assert "jax" not in sys.modules and "repro" not in sys.modules
    # float32 matmuls and convolutions in full float32 (the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    for template, usage in flash_ptxas(
            (_build.BUILD_DIR / "flash_attention.log").read_text()):
        log(f"  flash_attention<{template}> (head dims up to {template}): "
            f"{usage}")

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

    # 3. kernels against their plain versions (CUDA events only: the
    # profiler's device times come after the paths, which run with nothing
    # recorded; see the module's docstring)
    log("kernels vs plain (exact), CUDA-event times:")
    kernel_rows = check_kernels(torch, kops, ref, fact_np)

    # 4. the JS-OJ path
    oj_model = fraud_model("store")
    cold, warm, counts_oj, rows_oj = drive(
        torch, kops, ExtractionEngine(tpcds), oj_model,
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
        use_kernel=False, use_bloom=False)).extract(oj_model)
    assert digests(plain.edges) == got, "JS-OJ kernel path != plain path"
    log("  edges == numpy bags == plain-torch path")
    oj_graph = cold.graph
    del plain, cold, warm
    torch.cuda.empty_cache()

    # 5. the JS-MV path
    t0 = time.perf_counter()
    dblp = make_dblp(scale=DBLP_SCALE)
    torch.cuda.synchronize()
    log(f"data: make_dblp(scale={DBLP_SCALE}) "
        f"{time.perf_counter() - t0:.2f} s, wrote "
        f"{dblp.stats['wrote'].rows} rows")
    mv_model = dblp_model()
    cold, warm, counts_mv, rows_mv = drive(
        torch, kops, ExtractionEngine(dblp), mv_model,
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
        use_kernel=False, use_bloom=False)).extract(mv_model)
    assert digests(plain.edges) == digests(cold.edges), \
        "JS-MV kernel path != plain path"
    log("  edge counts == numpy; digests == plain-torch path")
    del plain, cold, warm
    torch.cuda.empty_cache()

    # 6. analytics on the JS-OJ graph (and phase 3's graph kernels)
    graph_rows, counts_oja, _ = analytics_oj(
        torch, kops, ref, ExtractionEngine, tpcds, oj_model, oj_graph)
    del tpcds, oj_graph
    torch.cuda.empty_cache()

    # 7. analytics on the JS-MV graph
    counts_mva, _ = analytics_mv(torch, kops, ref, ExtractionEngine, dblp,
                                 mv_model, graph_rows)
    del dblp
    torch.cuda.empty_cache()

    # 8. the LM serving path: the flash kernel, then qwen2.5-3b full width
    log("flash_attention vs plain (bf16), CUDA-event times:")
    flash_rows = check_flash_kernel(torch, kops, ref)
    counts_lm, _ = serve_lm(torch, kops)
    torch.cuda.empty_cache()

    # 9. refresh and recovery: JS-OJ rounds (delta, delta, full, noop) on a
    # durable database, JS-MV through its maintained view, then recovery
    counts_oj_ref, counts_mv_ref, delta_counts = refresh_and_recovery(
        torch, kops, ref, ExtractionEngine)

    # the kernel phase: the kernel cases of 4-7 on untimed replays of the
    # paths, then every case's device time (a profiler session slows the
    # host's later launches, so it comes after every CUDA-event timing)
    tpcds = make_tpcds(sf=TPCDS_SF)
    dblp = make_dblp(scale=DBLP_SCALE)
    names = ("bloom_build", "bloom_prune_keys")
    (cold, _), calls = replay(
        torch, kops, names, counts_oj,
        lambda: extract_twice(ExtractionEngine(tpcds), oj_model))
    oj_csr = build_csr(cold.graph, oj_model, use_kernel=False)
    del cold
    _, calls_mv = replay(
        torch, kops, names, counts_mv,
        lambda: extract_twice(ExtractionEngine(dblp), mv_model))
    bloom_cases = record_bloom_calls(
        torch, kops, ref, kernel_rows,
        calls["bloom_build"] + calls_mv["bloom_build"])
    probe_cases, probe_pairs = record_probe_calls(
        torch, kops, ref, kernel_rows,
        calls["bloom_prune_keys"] + calls_mv["bloom_prune_keys"])
    del calls, calls_mv
    _, calls = replay(torch, kops, ["segment_counts", "frontier_expand"],
                      counts_oja,
                      lambda: analyze_oj(kops, ExtractionEngine(tpcds),
                                         oj_model))
    log("segment_counts on the operands of the JS-OJ launches:")
    segment_cases = record_segment_calls(torch, kops, ref, graph_rows,
                                         "JS-OJ", calls["segment_counts"])
    log("frontier_expand on the operands of the k-hop launches:")
    frontier_cases = record_frontier_calls(torch, kops, ref, graph_rows,
                                           calls["frontier_expand"])
    (pr, _), calls = replay(torch, kops, ["segment_counts"], counts_mva,
                            lambda: analyze_mv(ExtractionEngine(dblp),
                                               mv_model))
    mv_csr = pr.csr
    del pr
    log("segment_counts on the operands of the JS-MV launches:")
    segment_cases += record_segment_calls(torch, kops, ref, graph_rows,
                                          "JS-MV", calls["segment_counts"])
    del calls
    # phase 9's delta refreshes: every launch against its plain version,
    # the largest and most frequent operands timed
    refresh_cases = collections.defaultdict(list)
    for path, calls in replay_refresh(torch, kops, ExtractionEngine,
                                      delta_counts, counts_mv_ref).items():
        where = (f"{path} delta refresh"
                 + (f"es 1-{len(delta_counts)}" if path == "JS-OJ" else ""))
        check_every_call(torch, kops, ref, calls, where)
        refresh_cases["sorted_probe"] += record_sorted_probe_calls(
            torch, kops, ref, kernel_rows, calls["sorted_probe"], where)
        refresh_cases["bloom_build"] += record_bloom_calls(
            torch, kops, ref, kernel_rows, calls["bloom_build"], where)
        cases, pairs = record_probe_calls(
            torch, kops, ref, kernel_rows, calls["bloom_prune_keys"], where)
        refresh_cases["bloom_probe"] += cases
        probe_pairs += pairs
    del calls
    torch.cuda.empty_cache()

    log("device times (torch.profiler), every case above:")
    for kernel, (_, _, cases) in join_cases(torch, kops, ref,
                                            fact_np).items():
        add_device_times(torch, kernel_rows, kernel, cases)
    add_device_times(torch, kernel_rows, "bloom_build", bloom_cases)
    add_device_times(torch, kernel_rows, "bloom_probe", probe_cases)
    for kernel, cases in refresh_cases.items():
        add_device_times(torch, kernel_rows, kernel, cases)
    add_pair_device_times(torch, kernel_rows, probe_pairs)
    add_spec_device_times(torch, kops, graph_rows,
                          oj_graph_specs(torch, ref, oj_csr))
    add_spec_device_times(torch, kops, graph_rows,
                          mv_graph_specs(torch, ref, mv_csr))
    add_device_times(torch, graph_rows, "segment_counts", segment_cases)
    add_device_times(torch, graph_rows, "frontier_expand", frontier_cases)
    add_device_times(torch, flash_rows, "flash_attention",
                     flash_cases(torch, kops, ref))
    del bloom_cases, probe_cases, probe_pairs, segment_cases, \
        frontier_cases, refresh_cases, tpcds, dblp, oj_csr, mv_csr
    torch.cuda.empty_cache()

    by_path = {"js_oj": counts_oj, "js_mv": counts_mv,
               "js_oj_analytics": counts_oja, "js_mv_analytics": counts_mva,
               "lm_serve": counts_lm, "js_oj_refresh": counts_oj_ref,
               "js_mv_refresh": counts_mv_ref}
    kernel_rows += graph_rows + flash_rows
    untimed = [(row["name"], case["shape"]) for row in kernel_rows
               for case in row["cases"] if case["device_ms"] is None]
    assert not untimed, f"cases without a device time: {untimed}"
    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
