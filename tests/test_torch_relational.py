"""The port's relational layer against the JAX package: equal bags, exactly.

The same numpy tables (made from a seed) go through ``repro.relational``
and ``repro_torch.relational`` on the CPU; results compare as equal
``table_digest`` strings (valid rows, bag semantics, raw bytes — so a
column whose dtype drifted would differ) and equal required row counts.
"""
import numpy as np
import pytest
import torch

import repro.relational as jr
from repro.relational import join as jjoin
import repro_torch.relational as tr
from repro_torch.relational import join as tjoin

NULL32 = np.int32(2**31 - 1)


def _tables(n, seed, names, key_range=20, invalid=0.2, prefix=""):
    """One numpy table as (JAX Table, port Table)."""
    rng = np.random.default_rng(seed)
    cols = {f"{prefix}{c}": rng.integers(0, key_range, n).astype(np.int32)
            for c in names}
    valid = rng.random(n) >= invalid
    jt = jr.Table.from_arrays(**cols)
    jt = jt.mask(np.asarray(valid))
    tt = tr.Table.from_arrays(device="cpu", **cols).mask(torch.from_numpy(valid))
    return jt, tt


def _same(jt, tt):
    assert tr.table_digest(tt) == jr.table_digest(jt)
    assert tt.to_rowset() == jt.to_rowset()
    assert set(tt.columns) == set(jt.columns)
    for name, col in tt.columns.items():
        assert str(col.dtype).replace("torch.", "") == str(jt[name].dtype), \
            name


@pytest.mark.parametrize("column", [
    pytest.param(np.arange(5), id="numpy-int64"),
    pytest.param(np.arange(5, dtype=np.uint64) + 2**40, id="numpy-uint64"),
    pytest.param(np.linspace(0.1, 2.5, 5), id="numpy-float64"),
    pytest.param([3, 1, 4, 1, 5], id="python-int"),
    pytest.param([1.5, 2, 3, 4, 5], id="python-float"),
    pytest.param(np.array([True, False, True, True, False]), id="bool"),
    pytest.param([True, False, True, True, False], id="python-bool"),
    pytest.param(np.arange(5, dtype=np.int32) - 2, id="numpy-int32"),
    pytest.param(np.arange(5, dtype=np.float32), id="numpy-float32"),
])
def test_from_arrays_canonicalises_dtypes_as_jax(column):
    """numpy and Python inputs narrow as ``jnp.asarray`` narrows them (x64
    off): int64 -> int32, uint64 -> uint32, float64 -> float32; bool and
    32-bit types stay."""
    key = np.arange(5, dtype=np.int32)
    jt = jr.Table.from_arrays(capacity=8, k=key, c=column)
    tt = tr.Table.from_arrays(capacity=8, device="cpu", k=key, c=column)
    _same(jt, tt)


@pytest.mark.parametrize("column", [
    pytest.param([1, 2**40], id="python-2**40"),
    pytest.param([1, 2**31], id="python-2**31"),
    pytest.param([-2**31 - 1, 0], id="python-below-int32"),
    pytest.param(np.array([1, 2**40]), id="numpy-int64-wraps"),
    pytest.param([1, 2**31 - 1], id="python-int32-max"),
    pytest.param([1.5, 2**40], id="python-float-column"),
])
def test_from_arrays_python_ints_outside_int32_as_jax(column):
    """A Python int outside int32 in an integer column raises
    ``OverflowError`` in both packages (``jnp.asarray`` with x64 off; the
    port used to wrap it); numpy int64 arrays wrap in both, and a Python
    float column takes the int as a float."""
    try:
        jt = jr.Table.from_arrays(k=np.arange(2, dtype=np.int32), c=column)
    except OverflowError:
        with pytest.raises(OverflowError, match="int32"):
            tr.Table.from_arrays(device="cpu", k=np.arange(2, dtype=np.int32),
                                 c=column)
        assert not isinstance(column, np.ndarray)
        return
    assert isinstance(column, np.ndarray) or column[1] in (2**31 - 1, 2**40)
    _same(jt, tr.Table.from_arrays(device="cpu",
                                   k=np.arange(2, dtype=np.int32), c=column))


@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
@pytest.mark.parametrize("value", [2**40, 2**32 + 2, 2**31, -2**31 - 1,
                                   2**31 - 1, -2**31])
def test_filter_table_python_ints_outside_int32_as_jax(dtype, value):
    """A filter value that is a Python int outside int32 raises
    ``OverflowError`` in both packages, for every column dtype (torch
    would wrap it: ``x > 2**40`` acting as ``x > 0``); inside int32 the
    two filters agree."""
    col = np.array([1, 2, 3, 5 if dtype == "bool" else -5])
    col = col.astype(dtype)
    jt = jr.Table.from_arrays(x=col)
    tt = tr.Table.from_arrays(device="cpu", x=col)
    for op in ("==", "!=", "<", "<=", ">", ">="):
        if not -2**31 <= value < 2**31:
            with pytest.raises(OverflowError):
                jr.filter_table(jt, "x", op, value)
            with pytest.raises(OverflowError):
                tr.filter_table(tt, "x", op, value)
        else:
            _same(jr.filter_table(jt, "x", op, value),
                  tr.filter_table(tt, "x", op, value))


def test_from_arrays_keeps_torch_dtypes():
    t = tr.Table.from_arrays(device="cpu", a=torch.arange(4),
                             b=torch.ones(4, dtype=torch.float64))
    assert t["a"].dtype == torch.int64 and t["b"].dtype == torch.float64


@pytest.fixture(scope="module")
def sides():
    left = _tables(300, 1, ("k", "x", "a"), prefix="L.")
    right = _tables(200, 2, ("k", "x", "b"), prefix="R.")
    return left, right


@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("on", [
    pytest.param([("L.k", "R.k")], id="one-cond"),
    pytest.param([("L.k", "R.k"), ("L.x", "R.x")], id="post-filter"),
])
@pytest.mark.parametrize("use_kernel,bloom", [(False, 0), (True, 256)])
def test_join_with_capacity_parity(sides, how, on, use_kernel, bloom):
    (jl, tl), (jrt, trt) = sides
    kw = dict(capacity=4096, use_kernel=use_kernel, bloom_bits=bloom)
    if how == "left_outer":
        jt, jreq = jjoin.left_outer_with_capacity(jl, jrt, on, "m", **kw)
        tt, treq = tjoin.left_outer_with_capacity(tl, trt, on, "m", **kw)
        assert tt["m"].dtype == torch.bool
    else:
        jt, jreq = jjoin.join_with_capacity(jl, jrt, on, how, **kw)
        tt, treq = tjoin.join_with_capacity(tl, trt, on, how, **kw)
    assert int(treq) == int(jreq)
    _same(jt, tt)


def _join_of(how, left, right, on, **kw):
    """(table, required) of one capacity join: ``inner`` and ``left_outer``
    through :func:`join_with_capacity` (the native outer path, whose extra
    conditions clear the indicator), ``left_outer_rows`` through
    :func:`left_outer_with_capacity` (with two conditions, the inner
    expansion on ``__rowid__`` plus the unmatched rows)."""
    if how == "left_outer_rows":
        return tjoin.left_outer_with_capacity(left, right, on, "m", **kw)
    return tjoin.join_with_capacity(left, right, on, how, indicator="m",
                                    **kw)


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_outer_rows"])
@pytest.mark.parametrize("on", [
    pytest.param([("L.k", "R.k")], id="one-cond"),
    pytest.param([("L.k", "R.k"), ("L.x", "R.x")], id="post-filter"),
])
@pytest.mark.parametrize("gather", [
    pytest.param({"L.a", "R.b"}, id="payload"),
    pytest.param({"L.k", "R.x"}, id="keys"),
    pytest.param({"R.b"}, id="right-only"),
    pytest.param(set(), id="none"),
])
def test_gather_keeps_the_full_joins_columns(sides, how, on, gather):
    """``gather=S`` gives the full join's columns S, its valid mask and its
    required count, bit for bit on every slot (padding included); the
    post-filter columns are gathered besides, and nothing else."""
    (_, tl), (_, trt) = sides
    kw = dict(capacity=1024, use_kernel=False)
    full, full_req = _join_of(how, tl, trt, on, **kw)
    part, part_req = _join_of(how, tl, trt, on, gather=gather, **kw)
    assert int(part_req) == int(full_req)
    assert part.capacity == full.capacity
    assert torch.equal(part.valid, full.valid)
    rest = {c for cond in on[1:] for c in cond}
    indicator = {"m"} if how != "inner" else set()
    assert set(part.columns) == gather | rest | indicator
    for name in part.columns:
        assert part[name].dtype == full[name].dtype, name
        assert torch.equal(part[name], full[name]), name


@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("bloom", [256, 1024, 16384])
def test_bloom_pruned_join_parity(how, bloom):
    """A join whose Bloom filter prunes most probe keys (wide left keys, a
    few right keys, NULL and negative left keys): equal digests and
    required counts in both packages, for inner and left-outer joins."""
    rng = np.random.default_rng(bloom)
    lk = rng.integers(-5000, 50_000, 600).astype(np.int32)
    lk[rng.random(600) < 0.05] = NULL32
    rk = rng.integers(0, 2000, 150).astype(np.int32)
    lv, rv = rng.random(600) < 0.9, rng.random(150) < 0.9
    cols_l = {"L.k": lk, "L.a": np.arange(600, dtype=np.int32)}
    cols_r = {"R.k": rk, "R.b": np.arange(150, dtype=np.int32)}
    jl, tl = (jr.Table.from_arrays(**cols_l).mask(lv),
              tr.Table.from_arrays(device="cpu", **cols_l).mask(
                  torch.from_numpy(lv)))
    jrt, trt = (jr.Table.from_arrays(**cols_r).mask(rv),
                tr.Table.from_arrays(device="cpu", **cols_r).mask(
                    torch.from_numpy(rv)))
    kw = dict(capacity=2048, bloom_bits=bloom, indicator="m")
    on = [("L.k", "R.k")]
    jt, jreq = jjoin.join_with_capacity(jl, jrt, on, how, **kw)
    tt, treq = tjoin.join_with_capacity(tl, trt, on, how, **kw)
    assert int(treq) == int(jreq)
    _same(jt, tt)
    # the filter does prune: most valid left keys miss the right side
    from repro_torch.kernels import ops as kops

    rk_t = tjoin.composite_key(trt, ("R.k",))
    bits = kops.bloom_build(rk_t, trt.valid & (rk_t != int(NULL32)), bloom)
    kept = kops.bloom_prune_keys(bits, tjoin.composite_key(tl, ("L.k",)))
    assert (kept.numpy() == NULL32).mean() > 0.5


@pytest.mark.parametrize("on", [[("L.k", "R.k")],
                                [("L.k", "R.k"), ("L.x", "R.x")]])
def test_eager_joins_parity(sides, on):
    (jl, tl), (jrt, trt) = sides
    _same(jr.sort_merge_join(jl, jrt, on), tr.sort_merge_join(tl, trt, on))
    _same(jr.left_outer_join(jl, jrt, on, "m"),
          tr.left_outer_join(tl, trt, on, "m"))
    assert int(tr.join_count(tl, trt, ("L.k",), ("R.k",))) == \
        int(jr.join_count(jl, jrt, ("L.k",), ("R.k",)))
    np.testing.assert_array_equal(
        tr.semi_join_mask(tl, trt, on).numpy(),
        np.asarray(jr.semi_join_mask(jl, jrt, on)))


@pytest.mark.parametrize("side", ["left", "right", "both"])
@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_empty_and_all_null_sides(sides, side, how):
    """No valid row on a side (every key NULL to the join) and all-NULL
    key values: bags and required counts still agree."""
    (jl, tl), (jrt, trt) = sides
    if side in ("left", "both"):
        jl, tl = jl.mask(np.zeros(jl.capacity, bool)), tl.mask(
            torch.zeros(tl.capacity, dtype=torch.bool))
    if side in ("right", "both"):
        nk = np.full(jrt.capacity, NULL32)
        jrt = jrt.with_columns(**{"R.k": nk})
        trt = trt.with_columns(**{"R.k": torch.from_numpy(nk)})
    on = [("L.k", "R.k")]
    jt, jreq = jjoin.join_with_capacity(jl, jrt, on, how, capacity=512,
                                        indicator="m")
    tt, treq = tjoin.join_with_capacity(tl, trt, on, how, capacity=512,
                                        indicator="m")
    assert int(treq) == int(jreq)
    _same(jt, tt)


def test_zero_capacity_sides_give_empty_joins():
    """Zero-row tables (which the JAX gathers reject) join to no rows."""
    left = tr.Table.from_arrays(device="cpu",
                                k=np.array([1, 2, 3], np.int32))
    empty = tr.Table.from_arrays(device="cpu", j=np.zeros(0, np.int32))
    for a, b, on in ((left, empty, [("k", "j")]), (empty, left, [("j", "k")])):
        out, req = tjoin.join_with_capacity(a, b, on, capacity=8)
        assert int(req) == 0 and not bool(out.valid.any())
    out, req = tjoin.join_with_capacity(left, empty, [("k", "j")],
                                        "left_outer", capacity=8,
                                        indicator="m")
    assert int(req) == 3 and out.to_numpy()["k"].tolist() == [1, 2, 3]
    assert not out.to_numpy()["m"].any()


def _gather0(col, idx):
    if col.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=col.dtype, device=col.device)
    return col[idx]


def _frozen_expansion(counts, match_counts, lo, order, capacity):
    """The join step's pair expansion as ``relational/join.py`` wrote it
    before the ``join_expand`` kernel (``_expansion`` plus the index work of
    ``_join_core``), kept here as the pin: (row, ridx, matched, valid,
    total)."""
    counts = counts.to(torch.int64)
    n = counts.shape[0]
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if n else torch.zeros((), dtype=torch.int64)
    slots = torch.arange(capacity, dtype=torch.int64)
    mark = torch.zeros((capacity + 1,), dtype=torch.int64)
    mark.index_add_(0, torch.clamp(cum, 0, capacity), torch.ones_like(cum))
    row = torch.clamp(torch.cumsum(mark, 0)[:capacity], 0, max(n - 1, 0))
    rank = slots - (_gather0(cum, row) - _gather0(counts, row))
    matched = rank < _gather0(match_counts, row)
    rpos = torch.clamp(_gather0(lo, row) + rank, 0,
                       max(order.shape[0] - 1, 0))
    return row, _gather0(order, rpos), matched, slots < total, total


# (left rows, right rows, capacity, share of trailing padding rows, share
# of zero-count rows among the live ones)
EXPAND_CASES = {
    "zero-counts-between-live-rows": (400, 120, 1024, 0.0, 0.5),
    "all-padding": (64, 50, 32, 1.0, 0.0),
    "no-left-rows": (0, 50, 16, 0.0, 0.0),
    "no-right-rows": (40, 0, 64, 0.2, 0.0),
    "total-over-capacity": (300, 200, 64, 0.1, 0.2),
    "trailing-75pct-padding": (1024, 300, 1024, 0.75, 0.3),
}


@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_join_expand_plain_pins_the_old_expansion(case, how):
    """``ref.join_expand`` (and the wrapper on a CPU tensor) give, slot for
    slot and padding included, what the scatter-and-scan expansion and
    ``_join_core``'s index arithmetic gave."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as tref

    n, rc, capacity, pad, zeros = EXPAND_CASES[case]
    rng = np.random.default_rng(len(case) + n)
    live = n - int(round(n * pad))
    valid = np.arange(n) < live
    lo = rng.integers(0, max(rc - 3, 1), n).astype(np.int32)
    mc = rng.integers(1, 4, n) * (rng.random(n) >= zeros) * valid
    mc = np.minimum(mc, rc - lo).astype(np.int32) if rc else mc * 0
    counts = np.where(valid, np.maximum(mc, 1), 0) if how == "left_outer" \
        else mc
    counts, mc, lo = (torch.from_numpy(a.astype(np.int32))
                      for a in (counts, mc, lo))
    order = torch.from_numpy(rng.permutation(rc).astype(np.int64))
    want = _frozen_expansion(counts, mc, lo, order, capacity)
    total = int(want[4])
    if case == "total-over-capacity":
        assert total > capacity
    if case == "trailing-75pct-padding":
        assert total < capacity
    cum = torch.cumsum(counts, 0, dtype=torch.int64)
    kops.reset_launch_counts()
    for got in (tref.join_expand(cum, mc, lo, order, capacity),
                kops.join_expand(cum, mc, lo, order, capacity)):
        for g, w in zip(got, want[:4]):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert kops.launch_counts()["join_expand"] == 0


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_overflow_signal_at_capacity_8(sides, how):
    (jl, tl), (jrt, trt) = sides
    on = [("L.k", "R.k")]
    jt, jreq = jjoin.join_with_capacity(jl, jrt, on, how, capacity=8,
                                        indicator="m")
    tt, treq = tjoin.join_with_capacity(tl, trt, on, how, capacity=8,
                                        indicator="m")
    assert int(treq) == int(jreq) > 8
    assert tt.capacity == 8
    _same(jt, tt)            # the same truncated prefix


def test_output_dtypes_match_reference(sides):
    (jl, tl), (jrt, trt) = sides
    on = [("L.k", "R.k"), ("L.x", "R.x")]
    tt, _ = tjoin.join_with_capacity(tl, trt, on, "left_outer",
                                     capacity=1024, indicator="m")
    jt, _ = jjoin.join_with_capacity(jl, jrt, on, "left_outer",
                                     capacity=1024, indicator="m")
    for name in jt.columns:
        assert str(tt[name].dtype) == f"torch.{jt[name].dtype}", name
    tt, _ = tjoin.left_outer_with_capacity(tl, trt, on, "m", capacity=1024)
    assert "__rowid__" not in tt.columns
    assert {str(c.dtype) for n, c in tt.columns.items() if n != "m"} == \
        {"torch.int32"}
    assert tt["m"].dtype == torch.bool and tt.valid.dtype == torch.bool


def test_compact_dedup_filter_concat_parity():
    jt, tt = _tables(500, 5, ("a", "b", "c"), key_range=6)
    _same(jr.filter_table(jt, "a", ">=", 3), tr.filter_table(tt, "a", ">=", 3))
    _same(jr.compact(jt), tr.compact(tt))
    jc, tc = jr.compact(jt, capacity=300), tr.compact(tt, capacity=300)
    _same(jc, tc)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    for keys in (["a"], ["a", "b"], ["c", "a", "b"]):
        jd, td = jr.dedup(jt, keys), tr.dedup(tt, keys)
        _same(jd, td)
        # the same representative row per key (stable lexicographic sort)
        for name in jt.columns:
            np.testing.assert_array_equal(
                td[name].numpy()[td.valid.numpy()],
                np.asarray(jd[name])[np.asarray(jd.valid)])
    _same(jr.concat([jt, jc]), tr.concat([tt, tc]))
    assert tr.count_distinct(tt, "a") == jr.count_distinct(jt, "a")


def test_subtract_bag_parity():
    jt, tt = _tables(200, 9, ("a", "b"), key_range=4, invalid=0.1)
    jm, tm = _tables(30, 10, ("a", "b"), key_range=4, invalid=0.0)
    _same(jr.subtract_bag(jt, jm), tr.subtract_bag(tt, tm))
