"""The port's graph slice against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` (the Pallas
kernels in interpret mode, ``repro.kernels.ref``, ``repro.graph`` and the
engine) and through ``repro_torch`` on the CPU, where the kernel wrappers
take their plain PyTorch versions.  Integer and bool outputs (histograms,
labels, frontiers, CSR arrays, distances, degrees, edge digests) must be
equal exactly.  Float outputs carry a stated tolerance:

* ``edge_spmv``: atol 1e-6 on N(0,1) inputs.  Each output sums at most a
  few dozen float32 terms of magnitude ~1, so a different summation order
  (the Pallas kernel's one-hot matmul, the scatter) moves it by a few ulps
  of values below ~10, i.e. well under 1e-6.  Against a float64 sum of the
  same inputs, each vertex is held to twice the recursive-summation bound
  ``deg_in(v) * 2**-24 * sum |x[u]|``.
* PageRank: atol 1e-5 against the float64 numpy ground truth, the
  reference's own tolerance, and a relative tolerance against the JAX
  package (same float32 arithmetic, sums in another order): rtol 1e-5 on
  the 300-vertex graph, rtol 1e-4 on the sf=1 TPC-DS graph, whose item hubs
  (rank ~0.1) sum hundreds of terms, where the order alone moves a float32
  sum by up to ``deg * 2**-24 * sum`` (~2e-6 absolute, 2e-5 relative).

The CUDA kernels are held against the plain versions on a card by the
jax-free ``tests/test_torch_cuda.py``.
"""
import collections
import dataclasses
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as jpipe
import repro.api as japi
import repro.core.extract as jext
import repro.data as jdata
import repro.relational.ops as jops
from repro.graph import algorithms as jalg
from repro.graph import csr as jcsr
from repro.kernels import ref as jref
from repro.kernels.frontier import frontier_expand as pallas_frontier
from repro.kernels.label_prop import edge_min_label as pallas_min_label
from repro.kernels.segment_csr import segment_counts as pallas_counts
from repro.kernels.spmv import edge_spmv as pallas_spmv
import repro_torch.api as tapi
import repro_torch.core.extract as text
import repro_torch.data as tdata
import repro_torch.relational.ops as tops
from repro_torch.graph import algorithms as talg
from repro_torch.graph import csr as tcsr
from repro_torch.graph import reference as gref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref

SPMV_ATOL = 1e-6
PR_RTOL = 1e-5
PR_RTOL_HUBS = 1e-4
PR_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# (a) the four plain kernels against the Pallas kernels and repro's refs
# ---------------------------------------------------------------------------

def _coo_case(name):
    """The COO shapes of the reference's graph tests, on a fixed seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "single_vertex":
        # one vertex, a self-loop, plus an invalid padding slot
        return (np.array([0, 0], np.int32), np.array([0, 0], np.int32),
                np.array([True, False]), 1)
    if name == "empty_rows":
        # 64 vertices but every edge confined to the first 4
        n_e = 37
        return (rng.integers(0, 4, n_e).astype(np.int32),
                rng.integers(0, 4, n_e).astype(np.int32),
                rng.random(n_e) < 0.7, 64)
    if name == "ragged":
        # zipf-skewed degrees across the Pallas kernels' tile boundary
        n_e, n_v = 4000, 1500
        src = np.minimum(rng.zipf(1.3, n_e) - 1, n_v - 1).astype(np.int32)
        return (src, rng.integers(0, n_v, n_e).astype(np.int32),
                rng.random(n_e) < 0.8, n_v)
    if name == "all_invalid":
        n_e = 16
        return (rng.integers(0, 8, n_e).astype(np.int32),
                rng.integers(0, 8, n_e).astype(np.int32),
                np.zeros(n_e, bool), 8)
    if name == "neg_dst":
        # -1 destinations on valid slots: the kernels' contract drops them
        # (repro.kernels.ref would wrap them onto the last vertex)
        n_e, n_v = 300, 50
        dst = rng.integers(0, n_v, n_e).astype(np.int32)
        dst[rng.random(n_e) < 0.3] = -1
        return (rng.integers(0, n_v, n_e).astype(np.int32), dst,
                rng.random(n_e) < 0.9, n_v)
    raise KeyError(name)


CASES = ["single_vertex", "empty_rows", "ragged", "all_invalid", "neg_dst"]


def _wants(case, pallas, jax_ref, *args):
    """The Pallas kernel's answer, plus repro's ref where it agrees with
    the contract (no valid slot with dst = -1)."""
    out = [np.asarray(pallas(*args, interpret=True))]
    if case != "neg_dst":
        out.append(np.asarray(jax_ref(*args)))
    return out


def _spmv_bound(src, dst, valid, x, n):
    """float64 sums and twice the recursive-summation bound per vertex."""
    keep = valid & (dst >= 0) & (dst < n)
    s, d = src[keep], dst[keep]
    y64 = np.bincount(d, weights=x[s].astype(np.float64), minlength=n)
    deg = np.bincount(d, minlength=n)
    absum = np.bincount(d, weights=np.abs(x[s]).astype(np.float64),
                        minlength=n)
    return y64, 2.0 * deg * 2.0**-24 * absum + 1e-30


@pytest.mark.parametrize("case", CASES)
def test_edge_spmv_plain_matches_jax(case):
    src, dst, valid, n = _coo_case(case)
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    got = kops.edge_spmv(_t(src), _t(dst), _t(valid), _t(x), n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    jargs = [jnp.asarray(a) for a in (src, dst, valid, x)] + [n]
    for want in _wants(case, pallas_spmv, jref.edge_spmv, *jargs):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=SPMV_ATOL)
    y64, bound = _spmv_bound(src, dst, valid, x, n)
    assert (np.abs(_np(got) - y64) <= bound).all()


@pytest.mark.parametrize("case", CASES)
def test_edge_min_label_plain_matches_jax(case):
    src, dst, valid, n = _coo_case(case)
    labels = np.random.default_rng(2).permutation(n).astype(np.int32)
    got = kops.edge_min_label(_t(src), _t(dst), _t(valid), _t(labels), n)
    assert got.dtype == torch.int32
    jargs = [jnp.asarray(a) for a in (src, dst, valid, labels)] + [n]
    for want in _wants(case, pallas_min_label, jref.edge_min_label, *jargs):
        np.testing.assert_array_equal(_np(got), want)
    assert (_np(got) <= labels).all()      # include_self


@pytest.mark.parametrize("case", CASES)
def test_frontier_expand_plain_matches_jax(case):
    src, dst, valid, n = _coo_case(case)
    rng = np.random.default_rng(3)
    frontier = rng.random(n) < 0.3
    visited = (rng.random(n) < 0.2) | frontier
    got = kops.frontier_expand(_t(src), _t(dst), _t(valid), _t(frontier),
                               _t(visited), n)
    assert got.dtype == torch.bool
    jargs = [jnp.asarray(a) for a in (src, dst, valid, frontier, visited)]
    for want in _wants(case, pallas_frontier, jref.frontier_expand,
                       *jargs, n):
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n", [1, 100, 2048, 5000])
@pytest.mark.parametrize("segs", [1, 7, 100, 3000])
def test_segment_counts_plain_matches_jax(n, segs):
    rng = np.random.default_rng(n + segs)
    vals = rng.integers(0, segs, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = kops.segment_counts(_t(vals), _t(valid), segs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (segs,)
    jv, jm = jnp.asarray(vals), jnp.asarray(valid)
    np.testing.assert_array_equal(
        _np(got), np.asarray(pallas_counts(jv, jm, segs, interpret=True)))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jref.segment_counts(jv, jm, segs)))
    assert int(got.sum()) == int(valid.sum())


def test_segment_counts_drops_out_of_range_values():
    vals = np.array([-1, 0, 3, 4, 2**31 - 1, -7, 3], np.int32)
    valid = np.array([True, True, True, True, True, True, False])
    got = kops.segment_counts(_t(vals), _t(valid), 4)
    want = pallas_counts(jnp.asarray(vals), jnp.asarray(valid), 4,
                         interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), [1, 0, 0, 1])


def test_graph_wrappers_reject_bad_inputs():
    i32 = torch.arange(8, dtype=torch.int32)
    ok = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        kops.segment_counts(i32.to(torch.int64), ok, 8)
    with pytest.raises(ValueError):
        kops.segment_counts(i32, ok[:4], 8)
    with pytest.raises(TypeError):
        kops.edge_spmv(i32, i32, ok, i32, 8)          # x must be float32
    with pytest.raises(ValueError):
        kops.edge_spmv(i32, i32[:4], ok, i32.float(), 8)
    with pytest.raises(ValueError):
        kops.edge_min_label(i32, i32, ok, i32[:4], 8)
    with pytest.raises(TypeError):
        kops.frontier_expand(i32, i32, ok, i32, ok, 8)
    with pytest.raises(ValueError):
        kops.frontier_expand(i32, i32, ok, ok, ok[:4], 8)


SCATTER_TILE = _build.SCATTER_TILE_EDGES
SCATTER_MAX_BLOCKS = 132 * _build.SCATTER_BLOCKS_PER_SM     # on an H100


@pytest.mark.parametrize("n_sms", [1, 132])
@pytest.mark.parametrize("n_edges", [
    1, SCATTER_TILE - 1, SCATTER_TILE, SCATTER_TILE + 1,
    SCATTER_MAX_BLOCKS * SCATTER_TILE, SCATTER_MAX_BLOCKS * SCATTER_TILE + 1,
    2_880_000, 11_520_000, 25_187_109, 50_374_218, 2**40 + 3])
def test_scatter_grid_covers_the_edges_in_whole_tiles(n_edges, n_sms):
    """The launch of the CUDA edge_spmv / edge_min_label kernels: at most
    SCATTER_BLOCKS_PER_SM blocks an SM, each a contiguous range of whole
    tiles, none empty, and no fewer tiles a block than the cap on blocks
    allows (the C entries refuse any other grid)."""
    blocks, per_block = _build.scatter_grid(n_edges, n_sms)
    cap = n_sms * _build.SCATTER_BLOCKS_PER_SM
    assert per_block > 0 and per_block % SCATTER_TILE == 0
    assert 1 <= blocks <= cap
    assert (blocks - 1) * per_block < n_edges <= blocks * per_block
    tiles = -(-n_edges // SCATTER_TILE)
    fewer = per_block // SCATTER_TILE - 1
    assert fewer == 0 or -(-tiles // fewer) > cap


@pytest.mark.parametrize("n_edges,n_sms", [(0, 132), (-5, 132), (100, 0),
                                           (100, -1)])
def test_scatter_grid_rejects_an_empty_launch(n_edges, n_sms):
    with pytest.raises(ValueError, match="scatter_grid"):
        _build.scatter_grid(n_edges, n_sms)


def _strided_grid_accepted(blocks, n):
    """The C entries' check of a strided persistent grid (csrc/segment_csr.cu,
    csrc/bloom.cu): block b takes tiles b, b + blocks, ..., so any grid
    covers the input; they refuse one with no block or a block without a
    tile."""
    return 1 <= blocks <= -(-n // SCATTER_TILE)


@pytest.mark.parametrize("source", ["spmv", "label_prop", "segment_csr",
                                    "bloom"])
def test_grid_kernels_tile_as_scatter_grid(source):
    """Every kernel launched over scatter_grid tiles kThreads x kVec values,
    the tile that scatter_grid cuts the input into."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    threads, vec = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
                    for name in ("kThreads", "kVec"))
    assert threads * vec == SCATTER_TILE


@pytest.mark.parametrize("n_sms", [114, 132])
@pytest.mark.parametrize("n_values", [
    1, SCATTER_TILE - 1, SCATTER_TILE + 1,
    # segment_counts on the paths: Buy, Buy + Sell, Co-auth, Auth-Edit;
    # bloom_build's build side of 2.88M keys
    2_880_000, 5_760_000, 7_196_654, 17_990_455])
@pytest.mark.parametrize("source", ["segment_csr", "bloom"])
def test_segment_counts_and_bloom_grids_cover_the_input(source, n_values,
                                                        n_sms):
    """The grid segment_counts and bloom_build launch: scatter_grid's block
    count, which their C entries accept (no block without a tile), and
    whose strided tiles take every tile once.  Their C entries take the
    block count and no range (the signature in _build.SIGNATURES)."""
    blocks, _ = _build.scatter_grid(n_values, n_sms)
    tiles = -(-n_values // SCATTER_TILE)
    assert _strided_grid_accepted(blocks, n_values)
    assert not _strided_grid_accepted(tiles + 1, n_values)
    assert not _strided_grid_accepted(0, n_values)
    assert blocks <= n_sms * _build.SCATTER_BLOCKS_PER_SM
    taken = np.concatenate([np.arange(b, tiles, blocks)
                            for b in range(blocks)])
    assert np.array_equal(np.sort(taken), np.arange(tiles))
    entry = {"segment_csr": "repro_segment_counts",
             "bloom": "repro_bloom_build"}[source]
    text = (_build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    assert "int64_t blocks" in params and "per_block" not in params
    assert params.count(",") + 1 == len(_build.SIGNATURES[source][entry])


@pytest.mark.parametrize("n_sms", [114, 132])
@pytest.mark.parametrize("n_edges", [1, SCATTER_TILE - 1, SCATTER_TILE + 1,
                                     5_760_000, 11_520_000])
def test_frontier_grid_covers_the_edges(n_edges, n_sms):
    """frontier_expand launches scatter_grid's block count over strided
    tiles of kThreads x kVec edges, which its C entry accepts (no block
    without a tile); the entry takes the block count and no range, with
    the arity in _build.SIGNATURES."""
    blocks, _ = _build.scatter_grid(n_edges, n_sms)
    assert _strided_grid_accepted(blocks, n_edges)
    assert blocks <= n_sms * _build.SCATTER_BLOCKS_PER_SM
    text = (_build.CSRC / "frontier.cu").read_text()
    threads, vec = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
                    for name in ("kThreads", "kVec"))
    assert threads * vec == SCATTER_TILE
    entry = "repro_frontier_expand"
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    assert "int64_t blocks" in params and "per_block" not in params
    assert params.count(",") + 1 == len(_build.SIGNATURES["frontier"][entry])


@pytest.mark.parametrize("n_values", [0, -1])
def test_segment_counts_grid_rejects_an_empty_launch(n_values):
    with pytest.raises(ValueError, match="scatter_grid"):
        _build.scatter_grid(n_values, 132)
    # the wrapper answers an empty operand without a grid
    empty = torch.zeros((0,), dtype=torch.int32)
    counts = kops.segment_counts(empty, empty.bool(), 5)
    assert counts.dtype == torch.int32 and not bool(counts.any())


def test_cpu_graph_wrappers_never_launch():
    """(f) CPU tensors take the plain versions: every counter stays 0."""
    kops.reset_launch_counts()
    src, dst, valid, n = _coo_case("ragged")
    s, d, v = _t(src), _t(dst), _t(valid)
    kops.segment_counts(s, v, n)
    kops.edge_spmv(s, d, v, torch.ones(n), n)
    kops.edge_min_label(s, d, v, torch.arange(n, dtype=torch.int32), n)
    kops.frontier_expand(s, d, v, torch.ones(n, dtype=torch.bool),
                         torch.zeros(n, dtype=torch.bool), n)
    k = torch.arange(64, dtype=torch.int32)
    kops.sorted_probe(k, k)
    kops.bloom_probe(kops.bloom_build(k, torch.ones(64, dtype=torch.bool),
                                      256), k)
    kv = torch.zeros(1, 4, 1, 8)
    kops.flash_attention(torch.zeros(1, 4, 2, 8), kv, kv)
    counts = kops.launch_counts()
    assert set(counts) == {"sorted_probe", "join_expand", "bloom_build",
                           "bloom_probe", "segment_counts", "edge_spmv",
                           "edge_min_label", "frontier_expand",
                           "flash_attention"}
    assert all(v == 0 for v in counts.values()), counts


# ---------------------------------------------------------------------------
# (b) CSR layout: _coo_to_csr, transpose, apply_edge_delta
# ---------------------------------------------------------------------------

def _same_csr_arrays(tgraph, jgraph):
    assert tgraph.num_vertices == jgraph.num_vertices
    assert tgraph.edge_counts == jgraph.edge_counts
    assert tgraph.dirty == jgraph.dirty
    np.testing.assert_array_equal(_np(tgraph.vertex_ids),
                                  np.asarray(jgraph.vertex_ids))
    for field in ("offsets", "targets", "sources"):
        tarrs, jarrs = getattr(tgraph, field), getattr(jgraph, field)
        assert set(tarrs) == set(jarrs), field
        for label, arr in tarrs.items():
            assert arr.dtype == torch.int32, (field, label)
            np.testing.assert_array_equal(_np(arr), np.asarray(jarrs[label]),
                                          err_msg=f"{field}[{label}]")


def _graphs(src, dst, valid, n, label="E"):
    """The same COO edges laid out by both packages: (port, JAX)."""
    toff, ttgt, tsrc = tcsr._coo_to_csr(_t(src), _t(dst), _t(valid), n)
    joff, jtgt, jsrc = jcsr._coo_to_csr(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(valid), n)
    count = int(valid.sum())
    tg = tcsr.CSRGraph(
        num_vertices=n, vertex_ranges={"V": (0, n)},
        vertex_ids=torch.arange(n, dtype=torch.int32),
        offsets={label: toff}, targets={label: ttgt},
        sources={label: tsrc}, edge_counts={label: count})
    jg = jcsr.CSRGraph(
        num_vertices=n, vertex_ranges={"V": (0, n)},
        vertex_ids=jnp.arange(n, dtype=jnp.int32),
        offsets={label: joff}, targets={label: jtgt},
        sources={label: jsrc}, edge_counts={label: count})
    return tg, jg


@pytest.mark.parametrize("case", CASES[:4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_coo_to_csr_matches_jax(case, use_kernel):
    src, dst, valid, n = _coo_case(case)
    got = tcsr._coo_to_csr(_t(src), _t(dst), _t(valid), n,
                           use_kernel=use_kernel)
    want = jcsr._coo_to_csr(jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(valid), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_transpose_and_degrees_match_jax():
    src, dst, valid, n = _coo_case("ragged")
    tg, jg = _graphs(src, dst, valid, n)
    _same_csr_arrays(tg, jg)
    _same_csr_arrays(tg.transpose(), jg.transpose())
    np.testing.assert_array_equal(_np(tg.transpose().out_degree("E")),
                                  np.asarray(jg.transpose().out_degree("E")))
    np.testing.assert_array_equal(_np(tg.in_degree("E")),
                                  np.asarray(jg.in_degree("E",
                                                          use_kernel=False)))
    for symmetric in (False, True):
        for got, want in zip(tg.coo("E", symmetric=symmetric),
                             jg.coo("E", symmetric=symmetric)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(KeyError):
        tg.coo("nope")


def test_apply_edge_delta_tombstones_and_compaction_match_jax():
    rng = np.random.default_rng(11)
    n, n_e = 200, 900
    src = np.minimum(rng.zipf(1.4, n_e) - 1, n - 1).astype(np.int32)
    dst = rng.integers(0, n, n_e).astype(np.int32)
    tg, jg = _graphs(src, dst, np.ones(n_e, bool), n)
    # delete two live edges (one pair twice when duplicated), add three
    del_src = np.array([src[0], src[1], src[0]], np.int32)
    del_dst = np.array([dst[0], dst[1], dst[0]], np.int32)
    add_src = np.array([0, 0, n - 1], np.int32)
    add_dst = np.array([5, n - 1, 5], np.int32)
    tp = tg.apply_edge_delta("E", add_src, add_dst, del_src, del_dst)
    jp = jg.apply_edge_delta("E", add_src, add_dst, del_src, del_dst)
    assert "E" in tp.dirty
    _same_csr_arrays(tp, jp)
    np.testing.assert_array_equal(_np(tp.out_degree("E")),
                                  np.asarray(jp.out_degree("E")))
    # threshold 0 forces compaction back into clean CSR
    tc = tp.apply_edge_delta("E", del_src=add_src[:1], del_dst=add_dst[:1],
                             compact_threshold=0.0)
    jc = jp.apply_edge_delta("E", del_src=add_src[:1], del_dst=add_dst[:1],
                             compact_threshold=0.0)
    assert "E" not in tc.dirty
    _same_csr_arrays(tc, jc)
    off = _np(tc.offsets["E"])
    np.testing.assert_array_equal(off[1:] - off[:-1], _np(tc.out_degree("E")))
    live = collections.Counter(zip(src.tolist(), dst.tolist()))
    live.subtract(collections.Counter(zip(del_src.tolist(),
                                          del_dst.tolist())))
    live.update(zip(add_src[1:].tolist(), add_dst[1:].tolist()))
    s, d, v = [_np(a) for a in tc.coo("E")]
    assert collections.Counter(zip(s[v].tolist(), d[v].tolist())) == +live


# ---------------------------------------------------------------------------
# (c) the algorithms on the reference's 300-vertex Zipf graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zipf_graph():
    rng = np.random.default_rng(7)
    n_v, n_e = 300, 1200
    src = np.minimum(rng.zipf(1.4, n_e) - 1, n_v - 1).astype(np.int32)
    dst = rng.integers(0, n_v, n_e).astype(np.int32)
    tg, jg = _graphs(src, dst, np.ones(n_e, bool), n_v)
    return tg, jg, src, dst, n_v


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pagerank_matches_jax_and_numpy(zipf_graph, use_kernel):
    tg, jg, src, dst, n = zipf_graph
    got = talg.pagerank(tg, iters=12, use_kernel=use_kernel)
    assert got.dtype == torch.float32
    want = np.asarray(jalg.pagerank(jg, iters=12, use_kernel=False))
    np.testing.assert_allclose(_np(got), want, rtol=PR_RTOL, atol=0)
    truth = gref.pagerank_np(src, dst, np.ones(len(src), bool), n, iters=12)
    np.testing.assert_allclose(_np(got), truth, atol=PR_ATOL)
    assert abs(float(got.sum()) - 1.0) < 1e-3


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wcc_matches_jax(zipf_graph, use_kernel):
    tg, jg, src, dst, n = zipf_graph
    got = talg.wcc(tg, use_kernel=use_kernel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(jalg.wcc(jg, use_kernel=False)))
    np.testing.assert_array_equal(
        _np(got), gref.wcc_np(src, dst, np.ones(len(src), bool), n))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_khop_matches_jax(zipf_graph, use_kernel, k):
    tg, jg, src, dst, n = zipf_graph
    seeds = np.zeros(n, bool)
    seeds[[0, 5]] = True
    want = np.asarray(jalg.khop(jg, jnp.asarray(seeds), k=k,
                                use_kernel=False))
    got = talg.khop(tg, _t(seeds), k=k, use_kernel=use_kernel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    # index-array seeds (numpy, list, tensor) agree with the mask spelling
    for idx in (np.array([0, 5]), [0, 5], torch.tensor([0, 5])):
        np.testing.assert_array_equal(
            _np(talg.khop(tg, idx, k=k, use_kernel=use_kernel)), want)
    np.testing.assert_array_equal(
        _np(got), gref.khop_np(src, dst, np.ones(len(src), bool), seeds, n,
                               k=k))


# seed index arrays over n vertices: past the end, a negative index that
# wraps, none, and one index just outside each end of [-n, n)
KHOP_SEEDS = {"past_end": lambda n: [1, n + 2], "negative": lambda n: [-1, 2],
              "empty": lambda n: [], "outside_both": lambda n: [-n - 1, n]}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seeds", list(KHOP_SEEDS))
def test_khop_seed_indices_out_of_range_match_jax(seeds, use_kernel):
    """As the reference's ``.at[int32 seeds].set``: indices in [-n, 0) wrap,
    indices outside [-n, n) are dropped (n = 5: [1, 7], [-1, 2], [],
    [-6, 5])."""
    src = np.array([0, 1, 2, 3, 4, 1], np.int32)
    dst = np.array([1, 2, 3, 4, 0, 3], np.int32)
    tg, jg = _graphs(src, dst, np.ones(6, bool), 5)
    idx = KHOP_SEEDS[seeds](5)
    want = np.asarray(jalg.khop(jg, idx, k=2, use_kernel=False))
    got = talg.khop(tg, idx, k=2, use_kernel=use_kernel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_degree_stats_matches_jax(zipf_graph, use_kernel):
    tg, jg, *_ = zipf_graph
    got = talg.degree_stats(tg, use_kernel=use_kernel)
    want = jalg.degree_stats(jg, use_kernel=False)
    assert set(got) == set(want)
    for key, val in want.items():
        g = _np(got[key])
        assert str(g.dtype) == str(np.asarray(val).dtype), key
        np.testing.assert_array_equal(g, np.asarray(val), err_msg=key)


# ---------------------------------------------------------------------------
# (d) engine.analyze end to end, and (e) the baselines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over same-seed sf=1 TPC-DS databases."""
    return (japi.ExtractionEngine(jdata.make_tpcds(sf=1, seed=0)),
            tapi.ExtractionEngine(tdata.make_tpcds(sf=1, seed=0,
                                                   device="cpu")))


def test_engine_analyze_matches_jax(engines):
    je, te = engines
    model_t, model_j = tdata.fraud_model("store"), jdata.fraud_model("store")
    cold = te.analyze(model_t, algorithm="pagerank", label="Buy", iters=15)
    want = je.analyze(model_j, algorithm="pagerank", label="Buy", iters=15)
    assert not cold.provenance.csr_cache_hit
    assert cold.provenance.csr_key == want.provenance.csr_key
    _same_csr_arrays(cold.csr, want.csr)
    assert cold.csr.vertex_ranges == want.csr.vertex_ranges
    np.testing.assert_allclose(_np(cold.values), np.asarray(want.values),
                               rtol=PR_RTOL_HUBS, atol=0)
    s, d, v = [_np(a) for a in cold.csr.coo("Buy")]
    truth = gref.pagerank_np(s, d, v, cold.csr.num_vertices, iters=15)
    np.testing.assert_allclose(_np(cold.values), truth, atol=PR_ATOL)

    warm = te.analyze(model_t, algorithm="pagerank", label="Buy", iters=15)
    assert warm.provenance.csr_cache_hit           # CSR NOT rebuilt
    assert warm.provenance.extraction.plan_cache_hit
    assert warm.csr is cold.csr
    assert te.cache_info()["csrs"] == 1
    assert te.cache_info()["cache_bytes"]["csrs"] > 0

    for alg, kw in (("wcc", {}),
                    ("khop", dict(seeds=np.arange(3), k=2, label="Buy")),
                    ("degree_stats", {})):
        got = te.analyze(model_t, algorithm=alg, **kw)
        ref = je.analyze(model_j, algorithm=alg, **kw)
        assert got.provenance.csr_cache_hit, alg
        if isinstance(ref.values, dict):
            for key in ref.values:
                np.testing.assert_array_equal(
                    _np(got.values[key]), np.asarray(ref.values[key]))
        else:
            np.testing.assert_array_equal(_np(got.values),
                                          np.asarray(ref.values))
    with pytest.raises(ValueError, match="unknown algorithm"):
        te.analyze(model_t, algorithm="sssp")


@pytest.mark.parametrize("seeds", list(KHOP_SEEDS))
def test_engine_khop_seed_indices_out_of_range_match_jax(engines, seeds):
    je, te = engines
    model_t, model_j = tdata.fraud_model("store"), jdata.fraud_model("store")
    n = te.analyze(model_t, algorithm="degree_stats").csr.num_vertices
    idx = KHOP_SEEDS[seeds](n)
    got = te.analyze(model_t, algorithm="khop", seeds=idx, k=2)
    want = je.analyze(model_j, algorithm="khop", seeds=idx, k=2)
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))


def test_engine_graph_view_shares_cache(engines):
    te = engines[1]
    model = tdata.fraud_model("store")
    result = te.extract(model)
    before = te.cache_info()["csrs"]
    csr = result.graph_view()
    assert result.graph_view() is csr              # memoized on the result
    assert te.cache_info()["csrs"] == max(before, 1)
    ds = te.analyze(model, algorithm="degree_stats")
    assert ds.provenance.csr_cache_hit and ds.csr is csr
    # a result detached from the engine builds (and memoizes) its own CSR
    detached = dataclasses.replace(result, _engine=None, _csr=None)
    own = detached.graph_view()
    assert own is detached.graph_view() and own is not csr
    _same_csr_arrays(own, csr)
    # the kernel-path build (the wrapper's plain version on the CPU) agrees
    _same_csr_arrays(tcsr.build_csr(result.graph, model, use_kernel=True),
                     csr)


def test_csr_cache_is_content_addressed_across_methods(engines):
    te = engines[1]
    model = tdata.fraud_model("store")
    te.analyze(model, algorithm="degree_stats")
    via_ringo = te.analyze(model, algorithm="degree_stats", method="ringo")
    assert via_ringo.provenance.csr_cache_hit
    te.clear()
    assert te.cache_info()["csrs"] == 0


BASELINE_MODELS = {
    "fraud": ("tpcds", lambda d: d.fraud_model("store")),
    "recommendation": ("tpcds", lambda d: d.recommendation_model("store")),
    "combined": ("tpcds", lambda d: d.combined_model()),
    "dblp": ("dblp", lambda d: d.dblp_model()),
    "imdb": ("imdb", lambda d: d.imdb_model()),
}
MAKERS = {"tpcds": ("make_tpcds", dict(sf=1, seed=0)),
          "dblp": ("make_dblp", dict(scale=1, seed=1)),
          "imdb": ("make_imdb", dict(scale=1, seed=2))}


@pytest.fixture(scope="module")
def baseline_dbs():
    """{name: (JAX database, port database)}, made on first use."""
    memo = {}

    def get(name):
        if name not in memo:
            fn, kw = MAKERS[name]
            memo[name] = (getattr(jdata, fn)(**kw),
                          getattr(tdata, fn)(device="cpu", **kw))
        return memo[name]
    return get


@pytest.mark.parametrize("model_name", sorted(BASELINE_MODELS))
@pytest.mark.parametrize("method", ["ringo", "graphgen", "r2gsync"])
def test_baseline_digests_match_jax(baseline_dbs, model_name, method):
    db_name, mk = BASELINE_MODELS[model_name]
    jd, td = baseline_dbs(db_name)
    jedges, _, _ = jext.run_baseline(jd, mk(jdata).queries(), method)
    tedges, ext_s, conv_s = text.run_baseline(td, mk(tdata).queries(), method)
    assert ext_s >= 0.0 and conv_s >= 0.0
    assert {k: tops.table_digest(t) for k, t in tedges.items()} == \
        {k: jops.table_digest(t) for k, t in jedges.items()}
    assert text.plan_queries(td, mk(tdata).queries(), method) is None


def test_extract_graph_is_deprecated_and_runs_baselines(baseline_dbs):
    jd, td = baseline_dbs("tpcds")
    with pytest.warns(DeprecationWarning):
        graph, timings = text.extract_graph(td, tdata.fraud_model("store"),
                                            method="graphgen")
    with pytest.warns(DeprecationWarning):
        jgraph, _ = jext.extract_graph(jd, jdata.fraud_model("store"),
                                       method="graphgen")
    assert graph.fingerprint() == jgraph.fingerprint()
    assert timings.plan_s == 0.0
