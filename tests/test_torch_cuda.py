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
