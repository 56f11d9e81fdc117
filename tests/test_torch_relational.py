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
