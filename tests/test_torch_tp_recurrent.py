"""Tensor-parallel serving of the recurrent families: the mixers' channel
split over ``model`` (``tests/test_torch_tp_serve.py`` holds the harness
this file reuses, and its docstring the JAX side's placements).

* recurrentgemma-9b smoke at ``model`` 2: the RG-LRU's weights by channels
  (``w_out`` row-parallel), its ``h``/``conv`` states by channels, the
  ``swa`` layers' 2 heads split and their 1 KV head whole; the 16-token
  prompt over the window of 8 wraps the ring cache.  xlstm-1.3b smoke at
  ``model`` 2 (2 heads: the mLSTM's weights and gates split by heads, its
  memory by key rows, 16 of 32) and at 4 (the heads do not divide: a
  rank's column block is half a head, ``w_i``/``w_f`` whole, the key rows
  8 of 32 through the padded ``all_to_all``), and at ``data`` x ``model``
  = 2x2.  Each against the JAX package's jitted prefill and 3 decode steps
  under the same placements, and against the port's unsharded run, to
  ``LOGIT_TOL`` / ``CACHE_TOL`` (``check_case``); every rank asserts each
  parameter and cache block at ``local_shape`` of its placement
  (``check_blocks``), so the recurrent weights and states are split.
* Each mixer alone (``models.recurrent``) on the ranks of a ``gloo`` world
  against the whole mixer on the same inputs: the sequence form from a
  zero state and from a carried one, then a decode step, at world 2 (and
  the mLSTM with 2 heads at world 4).  Outputs to a bf16 ulp (2**-7: the
  row-parallel ``psum`` adds the bf16 parts in float32 and rounds once,
  where the whole matmul rounds its own float32 sum), states to
  ``STATE_TOL`` (they are the whole mixer's channels; only the mLSTM's
  float32 products of q and k may round apart).

Measured with this grid on the CPU: the logits within 0.0051 of JAX's
(recurrentgemma; xlstm within 0.0039) and within 0.0156 of the unsharded
run (0.0225 for ``forward`` at every position); the caches within 0.79 of
``CACHE_TOL``'s bound (recurrentgemma's ``swa`` keys after the prefill, a
few bf16 ulps: the split sums round otherwise, as GSPMD's do, and the
RG-LRU scan combines in another order than ``associative_scan``); at 1x4
xlstm's sLSTM ``m`` within 0.050 of JAX's, where JAX's own 1x4 run is
0.041 from its 1x2 run.  The mixers alone: outputs within a bf16 ulp,
states within 9e-8.
"""
import numpy as np
import pytest

import test_torch_tp_serve as serve

CASES = [("recurrentgemma-9b", "1x2"), ("xlstm-1.3b", "1x2"),
         ("xlstm-1.3b", "1x4"), ("xlstm-1.3b", "2x2")]
OUT_TOL = 2.0**-7
STATE_TOL = 1e-6
MIXERS = [("rglru", 2, 2), ("mlstm", 2, 2), ("mlstm", 4, 2),
          ("mlstm", 2, 4), ("slstm", 2, 2)]      # (mixer, world, heads)

EXTRA = r"""
# each mixer alone: rank r's blocks against the whole mixer
if world in (2, 4):
    from repro_torch.models import recurrent as rec
    mesh = meshes.get(f"1x{world}") or init_device_mesh(
        "cpu", (1, world), mesh_dim_names=("data", "model"))
    from repro_torch.models.layers import TP
    tp = TP(axis_group(mesh, "model"), world, rank)
    d, b, s = 64, 2, 7

    def cols(w):
        n = w.shape[-1] // world
        return w[..., rank * n:(rank + 1) * n].contiguous()

    def rows(w):
        n = w.shape[0] // world
        return w[rank * n:(rank + 1) * n].contiguous()

    for kind, wsize, heads in [(k, w, h) for k, w, h in
                               MIXERS_CFG if w == world]:
        gen = torch.Generator().manual_seed(7)
        x0, x1 = (torch.randn(b, s, d, generator=gen).to(torch.bfloat16)
                  for _ in range(2))
        xs = torch.randn(b, d, generator=gen).to(torch.bfloat16)
        tag = f"mixer/{kind}/{world}/{heads}/{rank}"
        if kind == "rglru":
            p = rec.init_rglru(gen, d, "cpu")
            mine = {k: rows(v) if k == "w_out" else v if k == "lam"
                    else cols(v) for k, v in p.items()}
            o0, h0 = rec.rglru_seq(p, x0)
            l0, lh0 = rec.rglru_seq(mine, x0, tp=tp)
            o1, h1 = rec.rglru_seq(p, x1, h0)
            l1, lh1 = rec.rglru_seq(mine, x1, lh0, tp=tp)
            conv = torch.zeros(b, rec.CONV_WIDTH - 1, d, dtype=torch.bfloat16)
            o2, h2, c2 = rec.rglru_step(p, xs, h1, conv)
            l2, lh2, lc2 = rec.rglru_step(mine, xs, lh1, cols(conv), tp)
            want_s, got_s = [cols(h0), cols(h1), cols(h2), cols(c2)], \
                [lh0, lh1, lh2, lc2]
        elif kind == "slstm":
            p = rec.init_slstm(gen, d, "cpu")
            mine = {k: rows(v) if k == "w_out" else cols(v)
                    for k, v in p.items()}
            o0, st0 = rec.slstm_seq(p, x0)
            l0, lst0 = rec.slstm_seq(mine, x0, tp=tp)
            o1, st1 = rec.slstm_seq(p, x1, st0)
            l1, lst1 = rec.slstm_seq(mine, x1, lst0, tp=tp)
            o2, st2 = rec.slstm_step(p, xs, st1)
            l2, lst2 = rec.slstm_step(mine, xs, lst1, tp)
            want_s = [cols(t) for t in st0 + st1 + st2]
            got_s = list(lst0 + lst1 + lst2)
        else:
            p = rec.init_mlstm(gen, d, heads, "cpu")
            mine = {k: v if k in ("w_i", "w_f") and heads % world
                    else cols(v) for k, v in p.items()}
            dk = d // heads // world

            def keys(st):
                c, n = st
                return [c[:, :, rank * dk:(rank + 1) * dk],
                        n[..., rank * dk:(rank + 1) * dk]]

            o0, st0 = rec.mlstm_seq(p, x0, heads)
            l0, lst0 = rec.mlstm_seq(mine, x0, heads, tp=tp)
            o1, st1 = rec.mlstm_seq(p, x1, heads, st0)
            l1, lst1 = rec.mlstm_seq(mine, x1, heads, lst0, tp=tp)
            want_s = keys(st0) + keys(st1)
            got_s = list(lst0) + list(lst1)
            o2, st2 = rec.mlstm_step(p, xs, st1, heads)
            l2, lst2 = rec.mlstm_step(mine, xs, lst1, heads, tp)
            want_s += keys(st2)
            got_s += list(lst2)
            assert lst2[0].shape[2] == dk, tuple(lst2[0].shape)
        for i, (w, g) in enumerate(zip([o0, o1, o2], [l0, l1, l2])):
            out[f"{tag}/out{i}"] = np.stack([g.float().numpy(),
                                             w.float().numpy()])
        for i, (w, g) in enumerate(zip(want_s, got_s)):
            assert g.shape == w.shape, (kind, i, g.shape, w.shape)
            out[f"{tag}/state{i}"] = np.stack([g.float().numpy(),
                                               w.float().numpy()])
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_recurrent")
    extra = work / "extra.py"
    extra.write_text(f"MIXERS_CFG = {MIXERS!r}\n" + EXTRA)
    return serve.run_grid(work, CASES, extra=extra)


@pytest.mark.parametrize("case", CASES, ids="/".join)
def test_tp_recurrent_serving_matches_jax(case, results):
    """Prefill's last logits, 3 decode steps' logits and the caches (the
    recurrent states gathered from their channel blocks), against the JAX
    package's jitted run under the same placements and against the port's
    unsharded run; ``forward`` against both (``check_case``)."""
    serve.check_case(case, *results)


def test_recurrent_states_come_back_whole(results):
    """The states gathered from every rank's blocks have the whole shapes:
    recurrentgemma's ``h`` (B, D) and ``conv`` (B, W-1, D), xlstm's mLSTM
    memory (B, H, Dh, Dh) and sLSTM ``c`` (B, D), stacked per cycle."""
    _, ranks = results
    got = ranks[2][0]
    rg = got["recurrentgemma-9b/1x2/cache/cycles/s0_rglru/conv"]
    assert rg.shape == (2, serve.B, 3, 64)
    for mtag in ("1x2", "1x4"):
        world = 4 if mtag == "1x4" else 2
        x = ranks[world][0]
        assert x[f"xlstm-1.3b/{mtag}/cache/cycles/s0_mlstm/c"].shape == \
            (1, serve.B, 2, 32, 32)
        assert x[f"xlstm-1.3b/{mtag}/cache/cycles/s3_slstm/c"].shape == \
            (1, serve.B, 64)


@pytest.mark.parametrize("kind,world,heads", MIXERS,
                         ids=[f"{k}-world{w}-heads{h}" for k, w, h in MIXERS])
def test_mixer_split_matches_whole(kind, world, heads, results):
    """Each rank's split mixer (its weight blocks, its state blocks, its
    place on the ``model`` axis as a ``layers.TP``) against the whole mixer
    on the same inputs: the sequence form from zero and from the carried
    state, then one decode step; outputs to a bf16 ulp, states to
    ``STATE_TOL``."""
    _, ranks = results
    for r in range(world):
        got = ranks[world][r]
        tag = f"mixer/{kind}/{world}/{heads}/{r}"
        outs = [k for k in got if k.startswith(tag + "/out")]
        states = [k for k in got if k.startswith(tag + "/state")]
        assert len(outs) == 3 and len(states) >= 4, sorted(got)
        for key in outs:
            g, w = got[key]
            np.testing.assert_allclose(g, w, rtol=OUT_TOL, atol=OUT_TOL,
                                       err_msg=key)
        for key in states:
            g, w = got[key]
            np.testing.assert_allclose(g, w, rtol=STATE_TOL, atol=STATE_TOL,
                                       err_msg=key)
