"""The hand-written CUDA kernels against their plain versions, on a card.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips without a card (decided in the
``cuda`` fixture, never at import).  Integer and bool kernels must equal
their plain versions exactly.  ``edge_spmv`` sums float32 with atomics in
an order that changes from run to run, so it and its plain version are
each held, per vertex, to twice the recursive-summation bound of a float64
sum of the same inputs.  ``flash_attention`` runs in bf16 and is held to
the reference test's rtol = atol = 2e-2: the kernel rounds the softmax
probabilities to bf16 before P V and the plain version keeps them in
float32, and each output is rounded to bf16 once, so the two may sit a
bf16 ulp or two apart (2**-7 relative at most per ulp).
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sorted_probe as kprobe

NULL32 = np.int32(2**31 - 1)
FLASH_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.detach().cpu().numpy()


def _coo_case(name):
    """Small COO edge cases on a fixed seed (as in test_torch_graph.py)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "single_vertex":
        # one vertex, a self-loop, plus an invalid padding slot
        return (np.array([0, 0], np.int32), np.array([0, 0], np.int32),
                np.array([True, False]), 1)
    if name == "all_invalid":
        n_e = 16
        return (rng.integers(0, 8, n_e).astype(np.int32),
                rng.integers(0, 8, n_e).astype(np.int32),
                np.zeros(n_e, bool), 8)
    if name == "neg_dst":
        # -1 destinations on valid slots: the kernels' contract drops them
        n_e, n_v = 300, 50
        dst = rng.integers(0, n_v, n_e).astype(np.int32)
        dst[rng.random(n_e) < 0.3] = -1
        return (rng.integers(0, n_v, n_e).astype(np.int32), dst,
                rng.random(n_e) < 0.9, n_v)
    raise KeyError(name)


def _spmv_bound(src, dst, valid, x, n):
    """float64 sums and twice the recursive-summation bound per vertex."""
    keep = valid & (dst >= 0) & (dst < n)
    s, d = src[keep], dst[keep]
    y64 = np.bincount(d, weights=x[s].astype(np.float64), minlength=n)
    deg = np.bincount(d, minlength=n)
    absum = np.bincount(d, weights=np.abs(x[s]).astype(np.float64),
                        minlength=n)
    return y64, 2.0 * deg * 2.0**-24 * absum + 1e-30


# ---------------------------------------------------------------------------
# the join kernels
# ---------------------------------------------------------------------------

FENCE = kprobe.MAX_FENCE


def _probe_matches_plain(sk, pk):
    before = kops.launch_counts()["sorted_probe"]
    lo, hi = kops.sorted_probe(sk, pk)
    rlo, rhi = tref.sorted_probe(sk, pk)
    torch.cuda.synchronize()
    assert kops.launch_counts()["sorted_probe"] == before + 1
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    return rlo, rhi


@pytest.mark.cuda
@pytest.mark.parametrize("n_sorted,n_probe", [
    (1, 1), (7, 63), (5000, 3000), (100_000, 2_880_000),
    # the fence: the whole build side (S <= F), one stride past it, two
    (FENCE - 1, 4000), (FENCE, 4000), (FENCE + 1, 4000), (2 * FENCE + 1, 5000),
    (2**22 + 5, 100_000)])
def test_cuda_sorted_probe_matches_plain(cuda, n_sorted, n_probe):
    rng = np.random.default_rng(n_sorted + n_probe)
    sk = np.sort(rng.integers(-50, n_sorted, n_sorted)).astype(np.int32)
    pk = rng.integers(-100, n_sorted + 100, n_probe).astype(np.int32)
    # probes at the ends: the first and last build keys, and past both
    ends = [sk[0], sk[-1], sk[0] - 1, sk[-1] + 1, -2**31, 2**31 - 1]
    pk[:min(n_probe, len(ends))] = ends[:n_probe]
    _probe_matches_plain(_t(sk, cuda), _t(pk, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zipf", "all-equal"])
def test_cuda_sorted_probe_duplicate_runs(cuda, case):
    """Runs of one key longer than the fence stride (Zipf hubs, as the item
    keys of store_sales) still give exact bounds."""
    rng = np.random.default_rng(3)
    if case == "zipf":
        sk = np.sort(np.minimum(rng.zipf(1.3, 1_000_000), 50_000))
    else:
        sk = np.full(3 * FENCE + 5, 7)
    sk = sk.astype(np.int32)
    pk = np.concatenate([rng.permutation(sk)[:200_000],
                         [sk[0] - 1, sk[-1] + 1, 0]]).astype(np.int32)
    rlo, rhi = _probe_matches_plain(_t(sk, cuda), _t(pk, cuda))
    assert int((rhi - rlo).max()) > kprobe.fence_stride(sk.size)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits,num_hashes", [(1, 256, 2), (5000, 1024, 3),
                                               (2_880_000, 16384, 2)])
def test_cuda_bloom_matches_plain(cuda, n, bits, num_hashes):
    rng = np.random.default_rng(n)
    keys = _t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), cuda)
    valid = _t(rng.random(n) < 0.8, cuda)
    got = kops.bloom_build(keys, valid, bits, num_hashes)
    want = tref.bloom_build(keys, valid, bits, num_hashes)
    assert torch.equal(got, want)
    assert torch.equal(kops.bloom_probe(got, keys, num_hashes),
                       tref.bloom_probe(want, keys, num_hashes))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_edge_cases_match_plain(cuda):
    null = torch.full((16,), int(NULL32), dtype=torch.int32, device=cuda)
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    for sk, pk in ((null, null[:7]), (empty, null), (null, empty)):
        got, want = kops.sorted_probe(sk, pk), tref.sorted_probe(sk, pk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    bits = kops.bloom_build(empty, empty.bool(), 256)
    assert int(bits.sum()) == 0
    assert kops.bloom_probe(bits, empty).shape == (0,)


def _expand_operands(slots, pad, how, seed, zeros=0.3, n=None, rc=None):
    """A join step's expansion operands on the CPU: ``n`` left rows (the
    slots by default) whose trailing rows are padding (count 0), so that
    about ``pad`` of the ``slots`` output slots lie past the total; live
    rows have 1-3 matches, or none for a share ``zeros`` of them (an outer
    join emits one row for those).  (cum, match_counts, lo, order)."""
    rng = np.random.default_rng(seed)
    n = slots if n is None else n
    rc = n // 2 if rc is None else rc
    mc = rng.integers(1, 4, n) * (rng.random(n) >= zeros)
    per_row = np.maximum(mc, how != "inner").mean() if n else 0
    live = min(n, int(slots * (1 - pad) / per_row)) if per_row else n
    mc[live:] = 0
    lo = rng.integers(0, max(rc - 3, 1), n)
    mc = np.minimum(mc, rc - lo) if rc else mc * 0
    counts = mc if how == "inner" else \
        np.where(np.arange(n) < live, np.maximum(mc, 1), 0)
    return (torch.from_numpy(np.cumsum(counts, dtype=np.int64)),
            _t(mc.astype(np.int32)), _t(lo.astype(np.int32)),
            torch.from_numpy(rng.permutation(rc).astype(np.int64)))


def _expand_matches_plain(operands, capacity, cuda):
    cum, mc, lo, order = (t.to(cuda) for t in operands)
    before = kops.launch_counts()["join_expand"]
    got = kops.join_expand(cum, mc, lo, order, capacity)
    want = tref.join_expand(cum, mc, lo, order, capacity)
    torch.cuda.synchronize()
    assert kops.launch_counts()["join_expand"] == before + (capacity > 0)
    for name, g, w in zip(("row", "ridx", "matched", "valid"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    return int(cum[-1]) if cum.shape[0] else 0


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("slots,pad", [(2**20, 0.25), (2**22, 0.5),
                                       (2**24, 0.75), (2**26, 0.25),
                                       (2**26, 0.75)])
def test_cuda_join_expand_matches_plain(cuda, slots, pad, how):
    """The kernel against the scatter-and-scan plain version, bit for bit
    on every output, at the main path's step sizes (pow-2 capacities, left
    sides as long as the output, their trailing rows padding)."""
    total = _expand_matches_plain(
        _expand_operands(slots, pad, how, seed=slots + int(100 * pad)),
        slots, cuda)
    assert abs(1 - total / slots - pad) < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "no-left-rows", "no-right-rows", "all-padding", "total-over-capacity",
    "ragged-capacity", "zero-count-runs", "one-slot", "no-slots",
    "left-longer-than-output"])
def test_cuda_join_expand_edge_cases(cuda, case):
    """Empty sides, no slot, a capacity off the tile and vector widths,
    more rows than slots, and runs of zero-count rows longer than a tile's
    shared-memory stage (the kernel then bisects in global memory)."""
    slots, kw = 2**16, {}
    how = "left_outer" if case in ("no-left-rows", "no-right-rows") \
        else "inner"
    if case == "no-left-rows":
        kw = dict(n=0, rc=100)
    elif case == "no-right-rows":
        kw = dict(rc=0)
    elif case == "all-padding":
        kw = dict(zeros=1.0)
    elif case == "zero-count-runs":
        kw = dict(n=2**22, zeros=0.9995)
    elif case == "left-longer-than-output":
        kw = dict(n=2**20)
    pad = 0.5
    if case == "total-over-capacity":
        pad = -1.0                     # twice the slots' worth of rows
    operands = _expand_operands(slots, pad, how, seed=7, **kw)
    capacity = {"ragged-capacity": slots + 3, "one-slot": 1,
                "no-slots": 0}.get(case, slots)
    total = _expand_matches_plain(operands, capacity, cuda)
    if case == "total-over-capacity":
        assert total > capacity
    if case == "zero-count-runs":
        gaps = np.diff(np.flatnonzero(np.diff(_np(operands[0]),
                                              prepend=0)))
        assert gaps.max() > 4096       # past kExpandStage rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tpcds", "dblp"])
def test_cuda_pipeline_join_expand_gives_the_plain_tables(cuda, case):
    """A compiled-pipeline request with ``use_kernel`` true (probe and
    expansion kernels) and false (plain versions), the Bloom prefilter off
    in both: every edge table equal, column by column and slot by slot,
    and one ``join_expand`` launch for each join step."""
    from repro_torch import obs
    from repro_torch.api import ExtractionEngine
    from repro_torch.core.pipeline import PipelineCompiler
    import repro_torch.data as tdata

    if case == "tpcds":
        db, model = tdata.make_tpcds(sf=50, device=cuda), \
            tdata.fraud_model("store")
    else:
        db, model = tdata.make_dblp(scale=1, device=cuda), tdata.dblp_model()
    obs.set_enabled(True)
    results = {}
    for use_kernel in (False, True):
        engine = ExtractionEngine(db, compiler=PipelineCompiler(
            use_kernel=use_kernel, use_bloom=False, device=cuda))
        before = kops.launch_counts()["join_expand"]
        with obs.span("test.request") as root:
            results[use_kernel] = engine.extract(model)
        torch.cuda.synchronize()
        launches = kops.launch_counts()["join_expand"] - before
        steps = sum(s["name"] == "pipeline.join"
                    for s in obs.TRACER.get(root.trace_id))
        assert steps > 0 and launches == (steps if use_kernel else 0)
    plain, kernel = results[False].edges, results[True].edges
    assert set(plain) == set(kernel)
    for label, t in plain.items():
        k = kernel[label]
        assert t.capacity == k.capacity and torch.equal(t.valid, k.valid)
        assert set(t.columns) == set(k.columns)
        for name, col in t.columns.items():
            assert torch.equal(col, k[name]), (label, name)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left_outer", "left_outer_rows"])
@pytest.mark.parametrize("n_conds", [1, 2])
def test_cuda_gather_keeps_the_full_joins_columns(cuda, how, n_conds):
    """A join on the card with the probe and expansion kernels, ``gather``
    set against not: the columns gathered, the valid mask and the required
    count equal the full join's on every slot, the post-filter columns
    are gathered besides, and ``join_expand`` runs once a join."""
    from repro_torch.relational import Table
    from repro_torch.relational import join as tjoin

    rng = np.random.default_rng(11)

    def side(n, prefix, names):
        cols = {f"{prefix}.{c}": rng.integers(0, hi, n).astype(np.int32)
                for c, hi in zip(names, (40_000, 4, 2**31 - 2))}
        valid = _t(rng.random(n) >= 0.1, cuda)
        return Table.from_arrays(device=cuda, **cols).mask(valid)

    left, right = side(200_000, "L", "kxa"), side(50_000, "R", "kxb")
    on = [("L.k", "R.k"), ("L.x", "R.x")][:n_conds]
    gather = {"L.a", "R.b"}

    def join(**kw):
        kw.update(capacity=2**19, use_kernel=True)
        if how == "left_outer_rows":
            return tjoin.left_outer_with_capacity(left, right, on, "m", **kw)
        return tjoin.join_with_capacity(left, right, on, how, indicator="m",
                                        **kw)

    full, full_req = join()
    before = kops.launch_counts()["join_expand"]
    part, part_req = join(gather=gather)
    torch.cuda.synchronize()
    assert kops.launch_counts()["join_expand"] == before + 1
    assert int(part_req) == int(full_req) <= 2**19
    assert torch.equal(part.valid, full.valid)
    rest = {c for cond in on[1:] for c in cond}
    assert set(part.columns) == (gather | rest
                                 | ({"m"} if how != "inner" else set()))
    for name, col in part.columns.items():
        assert torch.equal(col, full[name]), name


# ---------------------------------------------------------------------------
# the graph kernels
# ---------------------------------------------------------------------------

def _zipf_edges(n_edges, n_v, device, seed=0):
    """COO edges with Zipf sources (hubs) and a few -1 / invalid slots."""
    rng = np.random.default_rng(seed)
    src = np.minimum(rng.zipf(1.3, n_edges) - 1, n_v - 1).astype(np.int32)
    dst = np.minimum(rng.zipf(1.2, n_edges) - 1, n_v - 1).astype(np.int32)
    dst[rng.random(n_edges) < 0.01] = -1
    valid = rng.random(n_edges) < 0.95
    return _t(src, device), _t(dst, device), _t(valid, device)


EDGE_SIZES = [(1, 1), (5_000, 700), (5_760_000, 600_502)]


def _launched(name, fn):
    before = kops.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kops.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges,n_v", EDGE_SIZES)
def test_cuda_segment_counts_matches_plain(cuda, n_edges, n_v):
    src, _, valid = _zipf_edges(n_edges, n_v, cuda)
    got = _launched("segment_counts",
                    lambda: kops.segment_counts(src, valid, n_v))
    assert torch.equal(got, tref.segment_counts(src, valid, n_v))


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges,n_v", EDGE_SIZES)
def test_cuda_edge_spmv_matches_plain(cuda, n_edges, n_v):
    src, dst, valid = _zipf_edges(n_edges, n_v, cuda)
    x = _t(np.random.default_rng(1).normal(size=n_v).astype(np.float32), cuda)
    got = _launched("edge_spmv",
                    lambda: kops.edge_spmv(src, dst, valid, x, n_v))
    want = tref.edge_spmv(src, dst, valid, x, n_v)
    y64, bound = _spmv_bound(_np(src), _np(dst), _np(valid), _np(x), n_v)
    # atomics sum in another order: both within the bound of the exact sum
    assert (np.abs(_np(got) - y64) <= bound).all()
    assert (np.abs(_np(want) - y64) <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges,n_v", EDGE_SIZES)
def test_cuda_edge_min_label_matches_plain(cuda, n_edges, n_v):
    src, dst, valid = _zipf_edges(n_edges, n_v, cuda)
    labels = _t(np.random.default_rng(2).permutation(n_v).astype(np.int32),
                cuda)
    got = _launched("edge_min_label",
                    lambda: kops.edge_min_label(src, dst, valid, labels, n_v))
    assert torch.equal(got, tref.edge_min_label(src, dst, valid, labels, n_v))


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges,n_v", EDGE_SIZES)
def test_cuda_frontier_expand_matches_plain(cuda, n_edges, n_v):
    src, dst, valid = _zipf_edges(n_edges, n_v, cuda)
    rng = np.random.default_rng(3)
    frontier = _t(rng.random(n_v) < 0.1, cuda)
    visited = _t(rng.random(n_v) < 0.2, cuda) | frontier
    got = _launched("frontier_expand", lambda: kops.frontier_expand(
        src, dst, valid, frontier, visited, n_v))
    assert torch.equal(got, tref.frontier_expand(src, dst, valid, frontier,
                                                 visited, n_v))


SCATTER_CASES = ["one_hub", "distinct_over_slots", "colliding", "long_runs",
                 "misaligned"]
SCATTER_SIZES = {"small": (50_000, 20_000), "full": (5_760_000, 600_502)}
# the shared-memory table of csrc/spmv.cu and csrc/label_prop.cu: its
# multiplicative hash, 2**12 slots, probes of at most 16 slots
TABLE_HASH, TABLE_SLOT_BITS, TABLE_MAX_PROBE = 2654435769, 12, 16


def _home_slot(keys):
    return ((keys.astype(np.int64) * TABLE_HASH) & 0xFFFFFFFF) >> \
        (32 - TABLE_SLOT_BITS)


def _scatter_case(name, n_edges, n_v, per_block):
    """COO edges aimed at the scatter kernels' table; ``per_block`` is the
    edges of one block's range (``_build.scatter_grid``)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    src = rng.integers(0, n_v, n_edges).astype(np.int32)
    valid = rng.random(n_edges) < 0.95
    if name == "one_hub":                 # every edge into one vertex
        dst = np.full(n_edges, n_v - 1)
    elif name == "distinct_over_slots":
        # a stride through the vertices: at full size a block's range holds
        # more distinct destinations than the table has slots
        dst = np.arange(n_edges, dtype=np.int64) * 7919 % n_v
    elif name == "colliding":
        # destinations that share one home slot: past the probe bound they
        # go to the global atomic directly
        keys = np.arange(n_v)
        dst = rng.choice(keys[_home_slot(keys) == _home_slot(keys[-1:])],
                         n_edges)
    elif name == "long_runs":             # sorted runs longer than a range
        dst = np.arange(n_edges) // (4 * per_block)
    elif name == "misaligned":
        # the test passes views one element in: no 16-byte loads
        dst = rng.integers(0, n_v, n_edges)
    else:
        raise KeyError(name)
    return src, dst.astype(np.int32), valid


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SCATTER_SIZES))
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_cuda_scatter_kernels_adversarial(cuda, case, size):
    """edge_spmv within twice the recursive-summation bound and
    edge_min_label exactly equal to its plain version (first step and
    second step), on edge lists aimed at the shared-memory table."""
    n_edges, n_v = SCATTER_SIZES[size]
    _, per_block = _build.scatter_grid(
        n_edges, torch.cuda.get_device_properties(cuda).multi_processor_count)
    src, dst, valid = _scatter_case(case, n_edges, n_v, per_block)
    if case == "colliding" and size == "full":
        assert np.unique(dst).size > TABLE_MAX_PROBE
    if case == "distinct_over_slots" and size == "full":
        assert np.unique(dst[:per_block]).size > 2**TABLE_SLOT_BITS
    s, d, v = _t(src, cuda), _t(dst, cuda), _t(valid, cuda)
    if case == "misaligned":
        src, dst, valid, s, d, v = (a[1:] for a in (src, dst, valid, s, d, v))
        assert s.data_ptr() % 16 and d.data_ptr() % 16
    x = np.random.default_rng(1).normal(size=n_v).astype(np.float32)
    got = _launched("edge_spmv",
                    lambda: kops.edge_spmv(s, d, v, _t(x, cuda), n_v))
    y64, bound = _spmv_bound(src, dst, valid, x, n_v)
    assert (np.abs(_np(got) - y64) <= bound).all()
    labels = _t(np.random.default_rng(2).permutation(n_v).astype(np.int32),
                cuda)
    for _ in range(2):                    # WCC's first and second steps
        got = _launched("edge_min_label",
                        lambda: kops.edge_min_label(s, d, v, labels, n_v))
        want = tref.edge_min_label(s, d, v, labels, n_v)
        assert torch.equal(got, want)
        labels = want


@pytest.mark.cuda
def test_cuda_graph_edge_cases_match_plain(cuda):
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    none = empty.bool()
    before = kops.launch_counts()
    assert torch.equal(kops.segment_counts(empty, none, 5),
                       torch.zeros(5, dtype=torch.int32, device=cuda))
    assert torch.equal(kops.edge_spmv(empty, empty, none,
                                      torch.ones(3, device=cuda), 3),
                       torch.zeros(3, device=cuda))
    assert kops.launch_counts() == before          # empty: no launch
    for case in ("single_vertex", "all_invalid", "neg_dst"):
        src, dst, valid, n = _coo_case(case)
        s, d, v = _t(src, cuda), _t(dst, cuda), _t(valid, cuda)
        lab = torch.arange(n, dtype=torch.int32, device=cuda).flip(0)
        front = torch.ones(n, dtype=torch.bool, device=cuda)
        seen = torch.zeros(n, dtype=torch.bool, device=cuda)
        assert torch.equal(kops.segment_counts(d, v, n),
                           tref.segment_counts(d, v, n))
        assert torch.equal(kops.edge_min_label(s, d, v, lab, n),
                           tref.edge_min_label(s, d, v, lab, n))
        assert torch.equal(kops.frontier_expand(s, d, v, front, seen, n),
                           tref.frontier_expand(s, d, v, front, seen, n))
        x = torch.ones(n, device=cuda)
        assert torch.equal(kops.edge_spmv(s, d, v, x, n),
                           tref.edge_spmv(s, d, v, x, n))   # small integers
    torch.cuda.synchronize()


SEGMENT_CASES = ["one_hub", "sorted_runs_over_a_tile", "distinct_over_slots",
                 "colliding", "out_of_range", "all_invalid", "misaligned"]
SEGMENT_SIZES = {"small": (50_000, 20_000), "full": (5_760_000, 600_502)}
TILE = _build.SCATTER_TILE_EDGES


def _segment_case(name, n, n_v):
    """Values aimed at segment_counts' shared-memory table."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    valid = rng.random(n) < 0.95
    if name == "one_hub":                 # every value one bin
        values = np.full(n, n_v // 2)
    elif name == "sorted_runs_over_a_tile":
        values = np.arange(n) // (3 * TILE) % n_v
    elif name == "distinct_over_slots":
        # a stride through the bins: at full size a block's tiles hold
        # more distinct values than the table has slots (it flushes)
        values = np.arange(n, dtype=np.int64) * 7919 % n_v
    elif name == "colliding":
        # values that share one home slot: past the probe bound they go to
        # the global atomic directly
        keys = np.arange(n_v)
        values = rng.choice(keys[_home_slot(keys) == _home_slot(keys[-1:])],
                            n)
    elif name == "out_of_range":          # negative and >= n_v: not counted
        values = rng.integers(-n_v, 2 * n_v, n)
    elif name == "all_invalid":
        values = rng.integers(0, n_v, n)
        valid[:] = False
    elif name == "misaligned":
        # the test passes views one element in: no 16-byte loads
        values = np.minimum(rng.zipf(1.2, n) - 1, n_v - 1)
    else:
        raise KeyError(name)
    return values.astype(np.int32), valid


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SEGMENT_SIZES))
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_cuda_segment_counts_adversarial(cuda, case, size):
    """segment_counts exactly equal to its plain version, in one launch, on
    values aimed at its shared-memory table."""
    n, n_v = SEGMENT_SIZES[size]
    blocks, _ = _build.scatter_grid(
        n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    values, valid = _segment_case(case, n, n_v)
    if size == "full":
        if case == "colliding":
            assert np.unique(values).size > TABLE_MAX_PROBE
        if case == "distinct_over_slots":
            # block 0's strided tiles: 0, blocks, 2 blocks, ...
            first = values[:n - n % TILE].reshape(-1, TILE)[::blocks]
            assert np.unique(first).size > 2**TABLE_SLOT_BITS
    v, ok = _t(values, cuda), _t(valid, cuda)
    if case == "misaligned":
        v, ok = v[1:], ok[1:]
        assert v.data_ptr() % 16 and ok.data_ptr() % 4
    got = _launched("segment_counts", lambda: kops.segment_counts(v, ok, n_v))
    assert torch.equal(got, tref.segment_counts(v, ok, n_v))


BLOOM_KEYS = [1, 31, 2_049, 2_880_000]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [256, 16384])
@pytest.mark.parametrize("n", BLOOM_KEYS)
def test_cuda_bloom_build_one_launch_matches_plain(cuda, n, bits):
    rng = np.random.default_rng(n * 7 + bits)
    keys = _t(rng.integers(0, 4 * n, n).astype(np.int32), cuda)
    valid = _t(rng.random(n) < 0.9, cuda)
    got = _launched("bloom_build",
                    lambda: kops.bloom_build(keys, valid, bits))
    assert torch.equal(got, tref.bloom_build(keys, valid, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_invalid", "all_null", "negative",
                                  "misaligned"])
def test_cuda_bloom_build_edge_cases(cuda, case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 100_000
    keys = rng.integers(-2**31, 0, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "all_invalid":
        valid[:] = False
    elif case == "all_null":
        keys[:] = NULL32
        valid[:] = True
    k, v = _t(keys, cuda), _t(valid, cuda)
    if case == "misaligned":
        k, v = k[1:], v[1:]
    for bits in (256, 16384):
        got = _launched("bloom_build", lambda: kops.bloom_build(k, v, bits))
        assert torch.equal(got, tref.bloom_build(k, v, bits))
    if case == "all_invalid":
        assert not bool(got.any())


def _bloom_sides(cuda, seed):
    """A dense build side (2.88M keys) and a sparse one (31 keys)."""
    rng = np.random.default_rng(seed)
    dense = _t(rng.integers(0, 10**6, 2_880_000).astype(np.int32), cuda)
    sparse = _t(rng.integers(0, 10**6, 31).astype(np.int32), cuda)
    return ((dense, torch.ones_like(dense, dtype=torch.bool)),
            (sparse, torch.ones_like(sparse, dtype=torch.bool)))


@pytest.mark.cuda
def test_cuda_bloom_build_back_to_back_leaves_the_scratch_zero(cuda):
    """A sparse build right after a dense one on the same stream is exact:
    the dense one left the shared scratch and its ticket zero."""
    for keys, valid in _bloom_sides(cuda, 5) * 2:
        got = _launched("bloom_build",
                        lambda: kops.bloom_build(keys, valid, 16384))
        assert torch.equal(got, tref.bloom_build(keys, valid, 16384))


@pytest.mark.cuda
def test_cuda_bloom_build_on_two_streams(cuda):
    """Two builds in flight on two streams each use their stream's scratch,
    and each stream's next build is exact."""
    sides = _bloom_sides(cuda, 6)
    streams = [torch.cuda.Stream(cuda) for _ in sides]
    before = kops.launch_counts()["bloom_build"]
    for _ in range(2):
        outs = []
        for stream, (keys, valid) in zip(streams, sides):
            stream.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(stream):
                assert _build.stream_ptr(cuda) == stream.cuda_stream
                outs.append(kops.bloom_build(keys, valid, 16384))
        torch.cuda.synchronize()
        for out, (keys, valid) in zip(outs, sides):
            assert torch.equal(out, tref.bloom_build(keys, valid, 16384))
        sides = sides[::-1]               # swap: each stream's next build
    assert kops.launch_counts()["bloom_build"] == before + 4


PROBE_KEYS = [1, 3, 5, 4 * 1024 + 1, 4 * 8192 + 1, 16_777_216]
PROBE_BITS = [1, 31, 1000, 1024, 16383, 16384]


def _probe_keys(rng, n):
    """n int32 probe keys: build-side keys, random ones (negatives among
    them), NULL_KEY and -1."""
    keys = rng.integers(-2**31, 2**31 - 1, n + 3).astype(np.int32)
    keys[::3] = rng.integers(0, 5000, keys[::3].size)
    keys[::7] = NULL32
    keys[::11] = -1
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("bits", PROBE_BITS)
@pytest.mark.parametrize("n", PROBE_KEYS)
def test_cuda_bloom_probe_and_prune_match_plain(cuda, n, bits):
    """bloom_probe and bloom_prune_keys exactly equal to their plain
    versions, one launch each, for 1-3 hashes, on views 0-3 elements in
    (unaligned keys: scalar loads and stores) and a bitset 1 element in
    (unaligned: packed by ballots)."""
    rng = np.random.default_rng(n * 17 + bits)
    build = _t(rng.integers(0, 5000, 3000).astype(np.int32), cuda)
    keys = _t(_probe_keys(rng, n), cuda)
    null = torch.tensor(int(NULL32), dtype=torch.int32, device=cuda)
    for num_hashes in (1, 2, 3):
        built = kops.bloom_build(build, torch.ones_like(build, dtype=bool),
                                 bits, num_hashes)
        spare = torch.cat([built[:1], built])[1:]      # 4 bytes in
        for b in (built, spare):
            for off in range(4):
                k = keys[off:off + n]
                assert k.shape == (n,)
                want = tref.bloom_probe(b, k, num_hashes)
                got = _launched("bloom_probe",
                                lambda: kops.bloom_probe(b, k, num_hashes))
                assert torch.equal(got, want)
                got = _launched("bloom_probe", lambda: kops.bloom_prune_keys(
                    b, k, num_hashes))
                assert got.dtype == torch.int32
                assert torch.equal(got, torch.where(want, k, null))
        assert spare.data_ptr() % 16


@pytest.mark.cuda
def test_cuda_bloom_probe_no_false_negatives_at_the_path_size(cuda):
    """Every valid build key probes True and is kept by the prune, on the
    join path's largest probe side (16,777,216 keys into 16,384 bits)."""
    rng = np.random.default_rng(8)
    n = 16_777_216
    keys = _t(rng.integers(0, 2**31 - 1, n).astype(np.int32), cuda)
    valid = _t(rng.random(n) < 0.1, cuda)
    bits = kops.bloom_build(keys, valid, 16384)
    hit = _launched("bloom_probe", lambda: kops.bloom_probe(bits, keys))
    assert bool(hit[valid].all())
    kept = _launched("bloom_probe", lambda: kops.bloom_prune_keys(bits, keys))
    assert torch.equal(kept[valid], keys[valid])
    assert torch.equal(hit, tref.bloom_probe(bits, keys))


FRONTIER_CASES = ["one_hub", "all_set", "empty", "visited_all_set",
                  "out_of_range", "misaligned", "ragged"]
FRONTIER_SIZES = {"small": (50_000, 700), "full": (5_760_000, 600_502)}


def _frontier_case(name, n_edges, n_v):
    """(src, dst, valid, frontier, visited) aimed at frontier_expand."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    src = rng.integers(0, n_v, n_edges)
    dst = rng.integers(0, n_v, n_edges)
    valid = rng.random(n_edges) < 0.95
    frontier = rng.random(n_v) < 0.01
    visited = frontier | (rng.random(n_v) < 0.2)
    if name == "one_hub":
        # 100k frontier edges into one vertex (at full size)
        hub_edges = min(100_000, n_edges // 2)
        src[:hub_edges] = rng.integers(0, 8, hub_edges)
        dst[:hub_edges] = n_v - 1
        frontier[:8] = True
        visited[n_v - 1] = False
    elif name == "all_set":
        frontier[:] = True
    elif name == "empty":
        frontier[:] = False
    elif name == "visited_all_set":
        visited[:] = True
    elif name == "out_of_range":
        # sources clip into the frontier; destinations outside [0, n) drop
        src = rng.integers(-n_v, 2 * n_v, n_edges)
        dst = rng.integers(-n_v, 2 * n_v, n_edges)
        frontier[0] = frontier[-1] = True
    return (src.astype(np.int32), dst.astype(np.int32), valid, frontier,
            visited)


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(FRONTIER_SIZES))
@pytest.mark.parametrize("case", FRONTIER_CASES)
def test_cuda_frontier_expand_adversarial(cuda, case, size):
    """frontier_expand exactly equal to its plain version, in one launch."""
    n_edges, n_v = FRONTIER_SIZES[size]
    src, dst, valid, frontier, visited = _frontier_case(case, n_edges, n_v)
    s, d, v, f, seen = (_t(a, cuda) for a in (src, dst, valid, frontier,
                                              visited))
    if case == "misaligned":
        s, d, v = s[1:], d[1:], v[1:]
        assert s.data_ptr() % 16 and d.data_ptr() % 16 and v.data_ptr() % 4
    elif case == "ragged":           # a tail shorter than a thread's 4
        s, d, v = s[:-3], d[:-3], v[:-3]
    got = _launched("frontier_expand", lambda: kops.frontier_expand(
        s, d, v, f, seen, n_v))
    want = tref.frontier_expand(s, d, v, f, seen, n_v)
    assert torch.equal(got, want)
    if case == "one_hub":
        assert bool(want[n_v - 1])
    if case in ("empty", "visited_all_set"):
        assert not bool(want.any())


# ---------------------------------------------------------------------------
# flash attention and the LM slice
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (B, Sq, Sk, Hq, Hkv, Dh, causal, window)
    pytest.param(4, 2048, 2048, 16, 2, 128, True, None, id="qwen2.5-3b"),
    pytest.param(1, 2048, 2048, 8, 1, 256, True, None, id="gemma-2b"),
    pytest.param(1, 8192, 8192, 32, 8, 120, True, 4096, id="h2o-danube"),
    pytest.param(1, 1, 1, 2, 1, 64, True, None, id="s1"),
    pytest.param(2, 200, 200, 4, 2, 32, True, None, id="s200-d32"),
    pytest.param(1, 256, 256, 4, 2, 128, False, None, id="non-causal"),
    pytest.param(1, 300, 300, 4, 4, 16, True, 64, id="window64-d16"),
    pytest.param(1, 333, 333, 8, 1, 64, True, None, id="mqa"),
    pytest.param(1, 64, 300, 2, 1, 64, False, None, id="sk>sq"),
    # Sq not a multiple of the 128-row query tile
    pytest.param(1, 1000, 1000, 4, 2, 128, True, None, id="s1000"),
    pytest.param(1, 129, 129, 2, 1, 128, True, None, id="s129"),
    # Dh 120 (zero-filled columns of the TMA box) and Dh 256, windowed
    pytest.param(1, 1000, 1000, 4, 2, 120, True, 256, id="d120-window256"),
    pytest.param(1, 300, 300, 2, 1, 256, True, 100, id="d256-window100"),
    pytest.param(2, 512, 512, 8, 2, 128, True, None, id="b2-gqa8/2"),
    pytest.param(1, 100, 400, 2, 1, 128, True, None, id="sk>sq-causal"),
    # 32 key tiles: the K/V ring wraps many times
    pytest.param(1, 4096, 4096, 2, 1, 128, True, None, id="s4096-ring"),
    # the MoE, recurrent and encoder-decoder families' prefill shapes
    pytest.param(4, 1536, 1536, 16, 16, 64, False, None,
                 id="seamless-encoder"),
    pytest.param(4, 256, 1536, 16, 16, 64, False, None,
                 id="seamless-cross"),
    pytest.param(4, 2048, 2048, 16, 1, 256, True, 2048,
                 id="recurrentgemma-window2048"),
    pytest.param(4, 2048, 2048, 64, 4, 128, True, None, id="qwen3-moe"),
    pytest.param(4, 2048, 2048, 40, 8, 128, True, None, id="llama4-scout"),
    # cross-attention over a source shorter than the prompt
    pytest.param(2, 300, 100, 4, 4, 64, False, None, id="sq>sk-non-causal"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda, b, sq, sk, hq, hkv, dh,
                                            causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq + dh)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=cuda)
               .to(torch.bfloat16) for s, h in ((sq, hq), (sk, hkv),
                                                (sk, hkv)))
    got = _launched("flash_attention", lambda: kops.flash_attention(
        q, k, v, causal=causal, window=window))
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=FLASH_TOL,
                               atol=FLASH_TOL)


FLASH_OFFSETS = [
    # (B, Sq, Sk, Hq, Hkv, Dh, causal, window, q_offset): a sequence-
    # parallel rank's rows against the gathered keys
    pytest.param(b, sq, sk, hq, hkv, dh, causal, window, off,
                 id=f"d{dh}-off{off}-{'causal' if causal else 'full'}"
                    + (f"-window{window}" if window else ""))
    for b, sq, sk, hq, hkv, dh in [(2, 512, 2048, 14, 2, 64),
                                   (1, 256, 1024, 8, 1, 128)]
    for off in (0, sk // 2 - sq // 2 + 7, sk - sq)
    for causal, window in [(True, None), (True, 300), (False, None)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window,off",
                         FLASH_OFFSETS)
def test_cuda_flash_attention_offset_matches_plain(cuda, b, sq, sk, hq, hkv,
                                                   dh, causal, window, off):
    """The query offset (offsets 0, mid-sequence, and the last block of
    queries) against the plain version with the same offset."""
    gen = torch.Generator(device=cuda).manual_seed(sq + dh + off)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=cuda)
               .to(torch.bfloat16) for s, h in ((sq, hq), (sk, hkv),
                                                (sk, hkv)))
    got = _launched("flash_attention", lambda: kops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=off))
    want = tref.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    if off == 0:       # offset 0 is the call without it, bit for bit
        assert torch.equal(got, kops.flash_attention(q, k, v, causal=causal,
                                                     window=window))


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        kops.flash_attention(q, q, q)
    odd = torch.zeros((1, 8, 2, 100), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        kops.flash_attention(odd, odd, odd)
    qb = q.to(torch.bfloat16).requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        kops.flash_attention(qb, qb.detach(), qb.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "h2o-danube-3-4b",
                                  "gemma-2b"])
def test_cuda_lm_kernel_path_matches_plain_path(cuda, arch):
    """The smoke model on the card: forward and prefill through the flash
    kernel against the plain attention path, then decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = _t(rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32),
                cuda)
    batch = {"tokens": tokens}
    before = kops.launch_counts()["flash_attention"]
    fast = forward(params, cfg, batch)
    assert kops.launch_counts()["flash_attention"] == before + \
        cfg.num_layers
    plain = forward(params, cfg, batch, use_kernel=False)
    # logits std ~0.16: the two attentions round their probabilities to
    # bf16 at other places, so hidden states sit a bf16 ulp or so apart
    torch.testing.assert_close(fast, plain, rtol=2.5e-2, atol=2.5e-2)
    logits, cache = prefill(params, cfg, batch, 48)
    plain_logits, plain_cache = prefill(params, cfg, batch, 48,
                                        use_kernel=False)
    torch.testing.assert_close(logits, plain_logits, rtol=2.5e-2,
                               atol=2.5e-2)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(4):
        logits, cache = decode_step(params, cfg, cache, tok)
        plain_logits, plain_cache = decode_step(params, cfg, plain_cache,
                                                tok)
        torch.testing.assert_close(logits, plain_logits, rtol=2.5e-2,
                                   atol=2.5e-2)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    assert int(cache["pos"]) == 44


FAMILIES = ["recurrentgemma-9b", "xlstm-1.3b", "seamless-m4t-medium",
            "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_lm_family_kernel_path_matches_plain_path(cuda, arch):
    """Each family's smoke model on the card: forward and prefill with
    every full-sequence attention through the flash kernel (windowed MQA,
    the encoder's, cross-attention), against the plain attention path,
    then 4 teacher-forced decode steps on both caches.  An MoE token whose
    routing differs between the paths (a near tie of its router logits,
    moved by the bf16 rounding of the probabilities) is left out of the
    comparison, and so are the later tokens of its row when the change
    was in a layer before the last; at least 80% of the tokens remain."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.models.moe import recording_routes, route_changes

    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    b, s = 2, 40
    batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), cuda)}
    if cfg.frontend == "frames":
        batch["frames"] = _t(rng.normal(size=(
            b, cfg.frontend_len, cfg.d_model)).astype(np.float32), cuda)
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "swa") for k in kinds)
    enc = cfg.encoder.num_layers if cfg.encoder else 0
    calls = n_attn + enc + (n_attn if cfg.encoder else 0)

    def routed_alike(fast_r, plain_r, shape):
        """Positions (``shape``, row-major) to compare: their routing agreed
        in every layer; and with ``shape`` (B, S), no earlier position of
        the row changed its routing in a layer before the last, which moves
        its keys and values in the later layers."""
        if cfg.moe is None:
            return torch.ones(shape, dtype=torch.bool, device=cuda), \
                torch.zeros(shape[0], dtype=torch.bool, device=cuda)
        each = [route_changes([f], [p])[1].reshape(shape)
                for f, p in zip(fast_r, plain_r)]
        ok = torch.stack(each).all(0)
        early = ~torch.stack(each[:-1]).all(0)
        if len(shape) == 2:
            ok &= torch.cumsum(early.int(), dim=1) == 0
            early = early.any(1)
        return ok, early

    before = kops.launch_counts()["flash_attention"]
    with recording_routes() as fast_r:
        fast = forward(params, cfg, batch)
    assert kops.launch_counts()["flash_attention"] == before + calls
    with recording_routes() as plain_r:
        plain = forward(params, cfg, batch, use_kernel=False)
    ok, _ = routed_alike(fast_r, plain_r, (b, s))
    assert float(ok.float().mean()) >= 0.8
    torch.testing.assert_close(fast[ok], plain[ok], rtol=2.5e-2,
                               atol=2.5e-2)
    with recording_routes() as fast_r:
        logits, cache = prefill(params, cfg, batch, 48)
    with recording_routes() as plain_r:
        plain_logits, plain_cache = prefill(params, cfg, batch, 48,
                                            use_kernel=False)
    rows = routed_alike(fast_r, plain_r, (b, s))[0][:, -1]
    assert bool(rows.any())
    torch.testing.assert_close(logits[rows], plain_logits[rows],
                               rtol=2.5e-2, atol=2.5e-2)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(4):
        with recording_routes() as fast_r:
            logits, cache = decode_step(params, cfg, cache, tok)
        with recording_routes() as plain_r:
            plain_logits, plain_cache = decode_step(params, cfg,
                                                    plain_cache, tok)
        same, early = routed_alike(fast_r, plain_r, (b,))
        assert torch.isfinite(logits).all()
        torch.testing.assert_close(logits[rows & same],
                                   plain_logits[rows & same], rtol=2.5e-2,
                                   atol=2.5e-2)
        rows &= ~early
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    assert int(cache["pos"]) == s + 4


THREADS, THREAD_CALLS = 8, 24


def _join_kernels_in_thread(cuda, seed, scratches):
    """One worker of the threaded test: THREAD_CALLS rounds of the join
    kernels, each against its plain version, exact."""
    from repro_torch.kernels import bloom as kbloom

    rng = np.random.default_rng(seed)
    dev = torch.empty(0, device=cuda).device     # with its index, as keys'
    scratches.append(kbloom.build_scratch(dev, _build.stream_ptr(dev)))
    for _ in range(THREAD_CALLS):
        n = int(rng.integers(1, 60_000))
        keys = _t(rng.integers(0, 1 << 18, n).astype(np.int32), cuda)
        valid = _t(rng.random(n) < 0.8, cuda)
        probe = _t(rng.integers(0, 1 << 18, n).astype(np.int32), cuda)
        bits = kops.bloom_build(keys, valid, 4096)
        assert torch.equal(bits, tref.bloom_build(keys, valid, 4096))
        hit = tref.bloom_probe(bits, probe)
        assert torch.equal(kops.bloom_probe(bits, probe), hit)
        assert torch.equal(kops.bloom_prune_keys(bits, probe),
                           torch.where(hit, probe,
                                       torch.full_like(probe, NULL32)))
        sk = torch.sort(keys).values
        for got, want in zip(kops.sorted_probe(sk, probe),
                             tref.sorted_probe(sk, probe)):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_join_kernels_from_eight_threads(cuda):
    """Eight threads launch ``bloom_build``, ``bloom_probe`` (and its prune
    mode) and ``sorted_probe`` at once on the current stream, as the graph
    service's workers do: every call equals its plain version, all share
    the stream's one Bloom-build scratch, and after the threads join each
    wrapper's launch count is exactly the calls made."""
    import threading

    kops.reset_launch_counts()
    errors, scratches = [], []

    def worker(i):
        try:
            _join_kernels_in_thread(cuda, 100 + i, scratches)
        except BaseException as e:       # re-raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    assert len({s.data_ptr() for s in scratches}) == 1
    counts = kops.launch_counts()
    calls = THREADS * THREAD_CALLS
    assert (counts["bloom_build"], counts["bloom_probe"],
            counts["sorted_probe"]) == (calls, 2 * calls, calls)


def _train_inputs(device):
    """qwen2.5-3b smoke parameters (drawn on the CPU), fresh AdamW state and
    a token batch, on ``device``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training.data import TokenPipeline
    from repro_torch.training.optim import AdamW

    cfg = get_smoke_config("qwen2.5-3b")
    params = _to_device(init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"), device)
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=32,
                          seed=1).batch_at(0)
    batch = {k: _t(v, device) for k, v in batch.items()}
    return cfg, params, AdamW().init(params), batch


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_train_step_matches_cpu(cuda, remat):
    """One AdamW train step of qwen2.5-3b smoke on the card against the
    same step on the CPU, from the same parameters, state and batch.  The
    tolerances are those of ``tests/test_torch_training.py`` (JAX against
    the port), with the loss to 1e-3: the card's bf16 GEMMs may reduce
    split sums in bf16 (``allow_bf16_reduced_precision_reduction``, on by
    default), a partial sum rounded to 2**-8, where the CPU's keep float32.
    The new bf16 parameters agree to one bf16 ulp where the gradient's
    sign is certain (|m| above 2**-5 of its leaf's largest), to 2 lr plus
    an ulp elsewhere; the step launches no flash kernel."""
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    grad_tol, ulp = 2.0**-5, 2.0**-7
    out = {}
    for dev in ("cpu", cuda):
        cfg, params, state, batch = _train_inputs(dev)
        step = make_train_step(cfg, AdamW(), TrainStepConfig(remat=remat))
        before = kops.launch_counts()["flash_attention"]
        params, state, metrics = step(params, state, batch)
        assert kops.launch_counts()["flash_attention"] == before
        out[str(dev)] = (float(metrics["loss"]), leaves(params),
                         leaves(state.m), leaves(state.v))
    (lc, pc, mc, vc), (lg, pg, mg, vg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-3, atol=1e-3)
    for got, want, tol in [(g, w, grad_tol) for g, w in zip(mg, mc)] + \
            [(g, w, 2 * grad_tol) for g, w in zip(vg, vc)]:
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    for g, w, m in zip(pg, pc, mc):
        got, want = _np(g.float()), _np(w.float())
        m = np.abs(_np(m))
        sure = m > grad_tol * m.max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=ulp, atol=0)
        np.testing.assert_allclose(got, want, rtol=ulp,
                                   atol=2 * AdamW().lr)


@pytest.mark.cuda
def test_cuda_checkpoint_saved_on_card_restores_on_cpu(cuda, tmp_path):
    """Parameters and AdamW state after a step on the card, saved by the
    port's CheckpointManager and restored onto the CPU (``like`` on the
    ``meta`` device): bit-equal to the card's tensors."""
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves

    cfg, params, state, batch = _train_inputs(cuda)
    params, state, _ = make_train_step(cfg, AdamW())(params, state, batch)
    tree = {"p": params, "o": state}
    CheckpointManager(str(tmp_path)).save(1, tree, blocking=True)
    meta = init_params(cfg, device="meta")
    like = {"p": meta, "o": AdamW().init(meta)}
    got = CheckpointManager(str(tmp_path)).restore(1, like, device="cpu")
    for g, w in zip(leaves(got), leaves(tree)):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w.cpu()))


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)
