"""The sharded train step's tensor-parallel compute over ``model`` on the
models whose ``model`` split is not by heads alone
(``tests/test_torch_train_sharded.py`` holds the harness this file reuses,
and its docstring the JAX side and the tolerances).

* llama3.2-3b smoke at ``model`` 2: its 3 heads do not divide 2, so
  ``act_sharding`` makes it sequence-parallel: each rank runs its 8 of the
  16 positions with whole weights, its keys and values gathered over the
  sequence (``adjoint="sum"``), the embedding and head vocab-parallel.
  Under ZeRO-1 (``zero_policy``'s choice: ``seq_par_z1`` stores every
  weight whole but the embedding) and under ZeRO-3 (the FFN stored split
  over ``model``, gathered whole), every weight's gradient is a partial
  sum over ``model`` too.
* recurrentgemma-9b smoke at ``model`` 2: the RG-LRU split by channels
  (``lam`` narrowed, the gates' input gathered), the ``swa`` layers' 2
  heads split and their 1 KV head whole.
* xlstm-1.3b smoke at ``model`` 2: the mLSTM's key rows (its ``q``/``k``
  ``all_to_all``s, the ``v`` and gate gathers with ``adjoint="sum"``, the
  output gather with ``"slice"``) and the sLSTM's channels.

Each case: 2 steps against the JAX package's jitted GSPMD step on the same
mesh and against the port's unsharded step (``_check_step``), the
gathered gradients against the unsharded step's (``GRAD_TOL``), and the
local block of each activation the step computes (``heads``, ``logits``,
``hidden``).  Beside the grid, on the ranks of a world of 2:

* the leaves every rank narrows to its block, or uses for its part alone
  (qwen2.5-3b's ``bq``, recurrentgemma's ``lam``, llama3.2-3b's embedding
  under ``seq_par``): their gathered gradients against the unsharded
  step's, so that half a gradient, which the loss would not show, fails;
* the vocab-parallel cross-entropy alone (``train_step.chunked_nll`` on a
  rank's block of the logits) against the whole one, in loss and in the
  gradient of the logits, with a remainder chunk and labels in both
  ranks' blocks, to ``XENT_RTOL`` (float32 sums in another order); and
  no collective of a qwen2.5-3b step gathers whole logits.
"""
import numpy as np
import pytest

import test_torch_train_sharded as base

CASES = [("llama3.2-3b", "1x2", 1, None), ("llama3.2-3b", "1x2", 1, "zero3"),
         ("recurrentgemma-9b", "1x2", 1, None),
         ("xlstm-1.3b", "1x2", 1, None)]
PARTS = {"llama": ["llama3.2-3b"], "recurrentgemma": ["recurrentgemma-9b"],
         "xlstm": ["xlstm-1.3b"]}
STEPS = 2
XENT_RTOL = 1e-5
RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
# the recurrent families' moment and gradient tolerance, in units of
# GRAD_TOL: about twice the JAX package's own spread between its 1x2 GSPMD
# step and its one-device step (1.76 for recurrentgemma, 1.67 for xlstm,
# test_recurrent_reference_rounds_apart_beyond_grad_tol)
RECURRENT_SCALE = 4.0
SPREAD_MAX = 2.0
# (arch, case of the grid or None: the ranks' own qwen2.5-3b step, leaf)
NARROWED = [("qwen2.5-3b", None, "cycles/s0_attn/attn/bq"),
            ("recurrentgemma-9b", CASES[2], "cycles/s1_rglru/rglru/lam"),
            ("llama3.2-3b", CASES[0], "embed")]

EXTRA = r"""
# beside the grid: narrowed leaves and the vocab-parallel loss, world 2
if world == 2:
    from repro_torch.mesh_axes import axis_group, recording_collectives
    from repro_torch.models.layers import TP

    mesh = mesh_of("1x2")
    ts1 = tts.TrainStepConfig(microbatches=1, remat=True)
    for arch, leaf in (("qwen2.5-3b", "cycles/s0_attn/attn/bq"),):
        cfg = tconfigs.get_smoke_config(arch)
        toks = tokens(cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                 "labels": torch.from_numpy(toks[:, 1:].copy())}
        cap = Capture()
        p0 = tmodels.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
        pd, sd = shd.shard_train_state(p0, toptim.AdamW().init(p0), cfg,
                                       mesh)
        with recording_collectives() as moved:
            tts.make_train_step(cfg, cap, ts1, sh=act_sharding(
                cfg, mesh, B, S))(pd, sd, batch)
        got = dict(flatten(cap.grads))[tuple(leaf.split("/"))]
        gathers = [n for kind, n in moved if kind == "all-gather"]
        out[f"gathers/{arch}/{rank}"] = np.array(
            [max(gathers, default=0), B * S * cfg.vocab_size * 4])
        # the AdamW step of phase 14d (Capture takes no global norm)
        sys.path.insert(0, sys.argv[1])
        import chip_smoke
        sh = act_sharding(cfg, mesh, B, S)
        with recording_collectives() as moved:
            tts.make_train_step(cfg, toptim.AdamW(), ts1, sh=sh)(pd, sd,
                                                                 batch)
        out[f"all-reduce/{arch}/{rank}"] = np.array([
            sum(n for kind, n in moved if kind == "all-reduce"),
            chip_smoke.step_reductions(pd, mesh, cfg, sh)])
        if rank == 0:
            p0 = tmodels.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
            tts.make_train_step(cfg, cap, ts1)(p0, toptim.AdamW().init(p0),
                                               batch)
            want = dict(flatten(cap.grads))[tuple(leaf.split("/"))]
            out[f"narrowed/{arch}"] = got.float().numpy()
            out[f"narrowed/{arch}/unsharded"] = want.float().numpy()

    # the vocab-parallel loss alone: chunks of 4 over 11 positions (two
    # chunks and a remainder of 3), V = 64 split 32 and 32
    tp = TP(axis_group(mesh, "model"), 2, rank)
    gen = torch.Generator().manual_seed(11)
    nv, bx, sx = 64, 2, 11
    logits = 3 * torch.randn(bx, sx, nv, generator=gen)
    labels = torch.randint(0, nv, (bx, sx), generator=gen)
    whole = logits.clone().requires_grad_()
    want = tts.chunked_nll(whole, labels, nv, chunk=4)
    want.backward()
    cols = slice(rank * nv // 2, (rank + 1) * nv // 2)
    block = logits[..., cols].clone().requires_grad_()
    with recording_collectives() as moved:
        got = tts.chunked_nll(block, labels, nv, tp, chunk=4)
        got.backward()
    out[f"xent/loss/{rank}"] = np.array([float(got), float(want)])
    out[f"xent/grad/{rank}"] = block.grad.numpy()
    out[f"xent/grad/want/{rank}"] = whole.grad[..., cols].numpy()
    out[f"xent/labels/{rank}"] = labels.numpy()
    out[f"xent/kinds/{rank}"] = np.array(sorted({k for k, _ in moved}))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's arrays, [rank r's arrays] of the world of 2)."""
    work = tmp_path_factory.mktemp("tp_train")
    extra = work / "extra.py"
    extra.write_text(EXTRA)
    cfg = base._config(work, cases=CASES, parts=PARTS, steps=STEPS,
                       extras=False, extra=extra, spread=RECURRENT)
    ref, ranks = base.run_harness(work, cfg, PARTS, (2,))
    return ref, ranks[2]


def _spread(ref, arch):
    """How far the JAX package's own GSPMD step at ``model`` 2 lies from
    its one-device step, in units of the moment tolerance: the largest
    over the leaves of max |m_2 - m_1| / (GRAD_TOL (max |m_1| + |m_1|))."""
    keys = base._keys(ref, f"spread/{arch}/m")
    assert keys
    return max(float((np.abs(
        base._f32(ref, f"{arch}/1x2/mb1/1/m/{key}")
        - base._f32(ref, f"spread/{arch}/m/{key}")) / (base.GRAD_TOL * (
            np.abs(base._f32(ref, f"spread/{arch}/m/{key}")).max()
            + np.abs(base._f32(ref, f"spread/{arch}/m/{key}"))))).max())
        for key in keys)


def _scale(arch):
    """The moments' tolerance, in units of ``GRAD_TOL``: 1, or
    ``RECURRENT_SCALE`` for the recurrent families."""
    return RECURRENT_SCALE if arch in RECURRENT else 1.0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_reference_rounds_apart_beyond_grad_tol(arch, results):
    """The recurrent families' gradients at smoke size move by more than
    ``GRAD_TOL`` under any other rounding (a one-ulp change of one weight
    moves xlstm's 5.3 x ``GRAD_TOL``): the JAX package's own step at
    ``model`` 2 lies that far from its one-device step, and no farther
    than ``SPREAD_MAX``, half of those families' tolerance below
    (``RECURRENT_SCALE``).  Half a gradient, or twice one, lies far
    beyond it (a relative error of 1/2 is 16 x ``GRAD_TOL``)."""
    ref, _ = results
    spread = _spread(ref, arch)
    assert 1.0 < spread < SPREAD_MAX, spread


@pytest.mark.parametrize("case", CASES, ids=base._tag)
def test_tp_step_matches_jax(case, results):
    """Each step's loss, moments and parameters, gathered whole, against
    the JAX package's GSPMD step on the same mesh."""
    ref, ranks = results
    for k in range(1, STEPS + 1):
        base._check_step(ranks[0], f"{base._tag(case)}/{k}", ref,
                         f"{base._jtag(case)}/{k}", k, _scale(case[0]))


@pytest.mark.parametrize("case", CASES, ids=base._tag)
def test_tp_step_matches_unsharded(case, results):
    """Each step against the port's unsharded step from the same state."""
    _, ranks = results
    got = ranks[0]
    for k in range(1, STEPS + 1):
        base._check_step(got, f"{base._tag(case)}/{k}", got,
                         f"{base._tag(case)}/{k}/unsharded", k,
                         _scale(case[0]))


@pytest.mark.parametrize("case", CASES, ids=base._tag)
def test_tp_gradients_match_unsharded(case, results):
    """The gradients the step hands the optimizer, gathered whole, against
    the unsharded step's, every leaf to ``GRAD_TOL`` (scaled for the
    recurrent families): a gradient that is a rank's part, or twice the
    whole, would be far outside it."""
    _, ranks = results
    got = ranks[0]
    prefix = f"grads/{base._tag(case)}"
    keys = base._keys(got, prefix + "/unsharded")
    assert keys
    for key in keys:
        want = base._f32(got, f"{prefix}/unsharded/{key}")
        assert np.abs(want).max() > 0, key
        base._close_grad(base._f32(got, f"{prefix}/{key}"), want,
                         tol=base.GRAD_TOL * _scale(case[0]), key=key)


@pytest.mark.parametrize("case", CASES, ids=base._tag)
def test_tp_step_computes_at_its_local_widths(case, results):
    """The activations each rank's step computes: llama3.2-3b's hidden
    states and heads at 8 of the 16 positions (all 3 heads: the sequence
    split), recurrentgemma's ``swa`` heads at 1 of 2, and every model's
    logits at 256 of the 512 vocabulary columns."""
    import repro_torch.configs as tconfigs

    _, ranks = results
    cfg = tconfigs.get_smoke_config(case[0])
    for rank, arrays in enumerate(ranks):
        def placed(field):
            return tuple(arrays[f"placed/{base._tag(case)}/{field}/{rank}"])
        assert placed("logits") == (base.B, base.S, cfg.vocab_size // 2)
        rows = base.S // 2 if case[0] == "llama3.2-3b" else base.S
        assert placed("hidden") == (base.B, rows, cfg.d_model)
        if case[0] == "llama3.2-3b":
            assert placed("heads") == (base.B, rows, 3, cfg.head_dim)
        if case[0] == "recurrentgemma-9b":
            assert placed("heads") == (base.B, rows, 1, cfg.head_dim)


@pytest.mark.parametrize("arch,case,leaf", NARROWED,
                         ids=[a for a, _, _ in NARROWED])
def test_narrowed_leaf_gradients_are_whole(arch, case, leaf, results):
    """A leaf every ``model`` rank narrows to its block (qwen2.5-3b's
    ``bq``, recurrentgemma's ``lam``) or, under ``seq_par``, takes the
    gradient of its own rows of (llama3.2-3b's vocab-parallel embedding):
    its gradient, reduced over ``model`` too and gathered, equals the
    unsharded step's (the tolerance of :func:`test_tp_gradients_match_
    unsharded`), nonzero on both ranks' halves.  Block by block, the
    relative error of the gathered gradient against the unsharded one is
    within ``GRAD_TOL`` (x ``RECURRENT_SCALE`` for ``lam``) and a
    quarter of its distance from half the unsharded block, which a rank's
    part alone would give."""
    _, ranks = results
    if case is None:
        got = ranks[0][f"narrowed/{arch}"]
        want = ranks[0][f"narrowed/{arch}/unsharded"]
    else:
        prefix = f"grads/{base._tag(case)}"
        got = base._f32(ranks[0], f"{prefix}/{leaf}")
        want = base._f32(ranks[0], f"{prefix}/unsharded/{leaf}")
    axis = 0 if leaf == "embed" else -1
    tol = base.GRAD_TOL * _scale(arch)
    for g, w in zip(np.split(got, 2, axis=axis), np.split(want, 2,
                                                         axis=axis)):
        assert np.abs(w).max() > 0, leaf
        whole = np.linalg.norm(g - w) / np.linalg.norm(w)
        half = np.linalg.norm(g - 0.5 * w) / np.linalg.norm(w)
        assert whole <= tol and whole <= half / 4, (leaf, whole, half)
    base._close_grad(got, want, tol=tol, key=leaf)


def test_vocab_parallel_xent_matches_whole(results):
    """``chunked_nll`` on each rank's 32 of 64 logit columns against the
    whole logits (two chunks of 4 and a remainder of 3, labels in both
    ranks' blocks): the loss and the gradient of the rank's logits to
    ``XENT_RTOL``; its collectives are all-reduces alone; and no
    collective of a qwen2.5-3b step at ``model`` 2 gathers as much as its
    whole float32 logits."""
    _, ranks = results
    labels = ranks[0]["xent/labels/0"]
    assert (labels < 32).any() and (labels >= 32).any()
    for rank, arrays in enumerate(ranks):
        got, want = arrays[f"xent/loss/{rank}"]
        np.testing.assert_allclose(got, want, rtol=XENT_RTOL)
        np.testing.assert_allclose(
            arrays[f"xent/grad/{rank}"], arrays[f"xent/grad/want/{rank}"],
            rtol=XENT_RTOL, atol=XENT_RTOL * np.abs(
                arrays[f"xent/grad/want/{rank}"]).max())
        assert list(arrays[f"xent/kinds/{rank}"]) == ["all-reduce"]
        largest, logits = arrays[f"gathers/qwen2.5-3b/{rank}"]
        assert largest < logits


def test_step_all_reduces_are_the_dry_runs_plus_the_steps_own(results):
    """What ``chip_smoke.py``'s phase 14d asserts of the card's step, on a
    qwen2.5-3b smoke AdamW step at 1x2: each rank's all-reduce bytes equal the
    dry run's record of the program on ``meta`` blocks of a fake world of
    2 (``chip_smoke.tp_train_reckoning``) plus the step's own reductions
    (``chip_smoke.step_reductions``: the biases' gradients over ``model``,
    the loss's and the global norm's scalars)."""
    import sys

    import repro_torch.configs as tconfigs

    sys.path.insert(0, str(base.ROOT))
    import chip_smoke

    _, ranks = results
    want = chip_smoke.tp_train_reckoning(
        tconfigs.get_smoke_config("qwen2.5-3b"), base.B, base.S, 2)
    assert want["all-reduce"] > 0
    for rank, arrays in enumerate(ranks):
        moved, own = arrays[f"all-reduce/qwen2.5-3b/{rank}"]
        assert own > 8
        assert moved == want["all-reduce"] + own, (moved, want, own)
