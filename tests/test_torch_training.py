"""The port's training slice (``repro_torch.training``, ``forward(remat=)``)
against the JAX package's, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:
parameters are drawn by JAX's ``init_params`` and carried across with
``params_from_jax``, optimizer state with ``optim.state_from_jax``.  The
JAX package runs op by op (``jax.disable_jit``), the convention of
``tests/test_torch_models.py``.  Tolerances, each with its reason:

* Loss (float32 mean of the float32 token losses): rtol = atol = 1e-4.
  The logits are bf16 matmul outputs that may round one ulp apart in the
  two frameworks (``test_torch_models``' LOGIT_TOL); averaged over the
  batch the loss moves far less (measured at most 7.6e-5 absolute, 1.2e-5
  relative, on recurrentgemma).
* Gradients: each leaf within rtol = ``GRAD_TOL`` = 2**-5 and atol =
  ``GRAD_TOL`` x its largest magnitude in JAX.  Gradients of bf16
  parameters are bf16 tensors built from bf16 cotangents: both frameworks
  round the same float32 sums to bf16, but a sum in another order may
  round one ulp apart, and the backward carries that ulp into later
  cotangents (measured at most 2.6 bf16 ulps, 0.0204 of the leaf's
  largest entry, on recurrentgemma's conv weights; 0.0107 on xlstm).
* One AdamW step of a model: the new moments to the gradient tolerance
  (m is 0.1 x the clipped gradient; v is its square, so twice that).
  The new bf16 parameters agree to one bf16 ulp where the gradient's sign
  is certain, i.e. where |m| is above the gradient tolerance: AdamW's
  first step moves each parameter by lr x sign(g), and an entry whose
  gradient is within the tolerance of 0 may take the other sign: those
  entries are held to 2 lr plus one ulp.
* Optimizers alone, on the same parameters and gradients: the new
  parameters to one bf16 ulp (rtol 2**-7) and the float32 state to rtol
  1e-6 with atol 1e-6 x the leaf's largest magnitude (the global norm
  sums in another order, so the clip scale may be an ulp apart; a moment
  sums terms of either sign, and where they cancel the error is the
  terms' ulps, not the result's: measured 3.3e-6 relative, 4.6e-8 of the
  leaf's largest entry, after three AdamW steps).
* Data pipelines and checkpoints: exact (bit-equal batches; equal bytes
  on disk and after restore).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro.training.checkpoint as jckpt
import repro.training.data as jtdata
import repro.training.optim as joptim
import repro.training.train_step as jts
import repro_torch.api as tapi
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.models as tmodels
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import GraphWalkPipeline, TokenPipeline
from repro_torch.training.trainer import (
    FailureInjector,
    StragglerMonitor,
    TrainerConfig,
    run_training,
    run_with_recovery,
)
from repro_torch.training.tree import flatten, leaves, unflatten

LOSS_TOL = 1e-4
GRAD_TOL = 2.0**-5
BF16_ULP = 2.0**-7
STATE_RTOL = 1e-6
B, S = 2, 20
GRAD_ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
              "xlstm-1.3b", "seamless-m4t-medium"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


def _jax_leaves(tree):
    """(key, leaf) of a JAX tree, keyed as the port's ``flatten``."""
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _pairs(ttree, jtree):
    """The port's and JAX's leaves side by side, with equal keys."""
    tl, jl = flatten(ttree), _jax_leaves(jtree)
    assert ["/".join(p) for p, _ in tl] == [k for k, _ in jl]
    return [("/".join(p), t, j) for (p, t), (_, j) in zip(tl, jl)]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Smoke configs of both packages and JAX's parameters as numpy."""
    jc = jconfigs.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp)


def _batch(jc, seed=0, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (b, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jc.frontend == "patch":
        out["embeds"] = rng.normal(
            size=(b, jc.frontend_len, jc.d_model)).astype(np.float32)
    if jc.encoder is not None:
        out["frames"] = rng.normal(
            size=(b, jc.frontend_len, jc.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


def _grads(tc, tparams, tbatch, remat=False):
    diff = [p.detach().requires_grad_(True) for p in leaves(tparams)]
    loss = tts._chunked_xent(unflatten(tparams, diff), tc, tbatch, None,
                             remat)
    return loss.detach(), unflatten(tparams, torch.autograd.grad(loss, diff))


def _close_grad(got, want, tol=GRAD_TOL, key=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=key)


# ---------------------------------------------------------------------------
# data pipelines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dblp_csrs():
    """The Co-auth CSR of make_dblp(scale=1), built by each package."""
    jcsr = japi.ExtractionEngine(jdata.make_dblp(scale=1)).extract(
        jdata.dblp_model()).graph_view()
    tcsr = tapi.ExtractionEngine(tdata.make_dblp(scale=1, device="cpu")) \
        .extract(tdata.dblp_model()).graph_view()
    return jcsr, tcsr


@pytest.mark.parametrize("vocab", [None, 4096, 512])
def test_walk_pipeline_matches_jax(vocab):
    """Walk batches bit-equal to JAX's over the CSR each package built
    (the two CSRs are equal: ``test_torch_graph``), for several steps; a
    vocabulary smaller than the graph clips every token but the first."""
    jcsr, tcsr = _dblp_csrs()
    assert tcsr.num_vertices == jcsr.num_vertices == 4200
    jp = jtdata.GraphWalkPipeline(csr=jcsr, label="Co-auth", batch=3,
                                  seq_len=17, seed=5, vocab_size=vocab)
    tp = GraphWalkPipeline(csr=tcsr, label="Co-auth", batch=3, seq_len=17,
                           seed=5, vocab_size=vocab)
    assert tp.vocab_size == jp.vocab_size
    for step in (0, 1, 7, 1000):
        got, want = tp.batch_at(step), jp.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_deterministic_and_seekable():
    pipe = TokenPipeline(vocab_size=97, batch=4, seq_len=8, seed=11)
    a = pipe.batch_at(42)
    b = pipe.batch_at(42)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = pipe.batch_at(43)
    assert not np.array_equal(a["tokens"], c["tokens"])
    jpipe = jtdata.TokenPipeline(vocab_size=97, batch=4, seq_len=8, seed=11)
    for step in (0, 42, 43):
        for k, v in jpipe.batch_at(step).items():
            np.testing.assert_array_equal(pipe.batch_at(step)[k], v)


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_setup(tmp_path):
    cfg = tconfigs.get_smoke_config("llama3.2-3b")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                         seed=3)
    tcfg = TrainerConfig(steps=12, ckpt_every=4,
                         ckpt_dir=str(tmp_path / "ckpt"))
    return cfg, tcfg, pipe


def test_failure_recovery_matches_clean_run(small_setup, tmp_path):
    cfg, tcfg, pipe = small_setup
    clean = run_training(cfg, tcfg, pipe, device="cpu")

    tcfg2 = TrainerConfig(steps=12, ckpt_every=4,
                          ckpt_dir=str(tmp_path / "ckpt2"))
    injector = FailureInjector(fail_at_step=9)
    recovered = run_with_recovery(cfg, tcfg2, pipe, injector, device="cpu")
    assert recovered["restarts"] == 1
    # post-restart losses equal the clean run's (exact replay from step 8)
    for step in range(8, 12):
        np.testing.assert_allclose(
            recovered["losses_by_step"][step], clean["losses"][step],
            rtol=1e-4, err_msg=f"divergence at step {step} after recovery")
    for a, b in zip(leaves(clean["final_params"]),
                    leaves(recovered["final_params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4)


def test_unrecovered_failure_raises(small_setup, tmp_path):
    cfg, _, pipe = small_setup
    tcfg = TrainerConfig(steps=5, ckpt_every=100,  # no ckpt before failure
                         ckpt_dir=str(tmp_path / "ckpt3"))
    injector = FailureInjector(fail_at_step=3)
    # the injector is one-shot: the restart from step 0 passes step 3
    out = run_with_recovery(cfg, tcfg, pipe, injector, device="cpu")
    assert out["restarts"] == 1
    assert out["start"] == 0 and len(out["losses"]) == 5


def test_checkpoint_atomic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3))}}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]          # GC keeps 2
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    assert mgr.latest_step() == 4


def test_restore_onto_another_device_and_dtype(tmp_path):
    """Saved from one placement, restored onto another: ``like`` on the
    ``meta`` device (shapes and dtypes only) and a target device; a
    ``like`` of another dtype casts, as the reference's ``astype``."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mgr.save(7, {"w": w}, blocking=True)
    like = {"w": torch.empty((8, 8), dtype=torch.float32, device="meta")}
    restored = mgr.restore(7, like, device="cpu")
    assert restored["w"].device.type == "cpu"
    torch.testing.assert_close(restored["w"], w, rtol=0, atol=0)
    half = mgr.restore(7, {"w": like["w"].to(torch.bfloat16)}, device="cpu")
    assert half["w"].dtype == torch.bfloat16
    torch.testing.assert_close(half["w"], w.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, {"w": torch.ones((4,))}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.empty((5,), device="meta")}, device="cpu")
    with pytest.raises(KeyError):
        mgr.restore(1, {"u": torch.empty((4,), device="meta")}, device="cpu")


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=3.0, warmup=3)
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 1.0)   # 10x median
    assert len(mon.events) == 1 and mon.events[0]["step"] == 10


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device`` the trainer and a restore run on the CUDA card,
    and raise without one (never falling back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    cfg = tconfigs.get_smoke_config("llama3.2-3b")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, TrainerConfig(steps=1, ckpt_dir=str(tmp_path)),
                     pipe)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"w": torch.empty(2, device="meta")})


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_gradient_step_finite(arch):
    """``test_arch_smoke.test_gradient_step_finite`` on the port: finite
    loss and gradients through every mixer (the xLSTM loops take their
    out-of-place forms under autograd)."""
    cfg = tconfigs.get_smoke_config(arch)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    _, tb = _both(_batch(jconfigs.get_smoke_config(arch), seed=7))
    diff = [p.detach().requires_grad_(True) for p in leaves(params)]
    logits = tmodels.forward(unflatten(params, diff), cfg, tb,
                             use_kernel=False)[:, -S:, :]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1,
                         tb["labels"][..., None].long()).mean()
    grads = torch.autograd.grad(loss, diff)
    assert bool(torch.isfinite(loss)), f"{arch}: NaN loss"
    assert all(bool(torch.isfinite(g).all()) for g in grads), \
        f"{arch}: NaN grad"


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The training loss (``_chunked_xent``) and every gradient leaf
    against ``jax.value_and_grad`` run op by op."""
    jc, tc, jp, np_params = _model(arch)
    jb, tb = _both(_batch(jc))
    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(lambda p: jts._chunked_xent(
            p, jc, jb, jmodels.ActSharding(), False))(jp)
    tloss, tgrads = _grads(tc, tmodels.params_from_jax(np_params, "cpu"), tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for key, t, j in _pairs(tgrads, jgrads):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        _close_grad(t, j, key=key)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b",
                                  "xlstm-1.3b", "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(arch):
    """``forward(remat=True)`` recomputes each cycle in the backward pass
    with the same operations: loss and gradients equal without remat."""
    jc, tc, _, np_params = _model(arch)
    _, tb = _both(_batch(jc))
    params = tmodels.params_from_jax(np_params, "cpu")
    loss, grads = _grads(tc, params, tb, remat=False)
    rloss, rgrads = _grads(tc, params, tb, remat=True)
    assert float(loss) == float(rloss)
    for g, r in zip(leaves(grads), leaves(rgrads)):
        assert torch.equal(g, r)


def test_chunked_xent_takes_chunks_and_a_remainder(monkeypatch):
    """S = 20 with chunks of 6: three chunks of 6 and a remainder of 2
    give JAX's loss; the chunk size does not change the loss beyond
    float32 sum order."""
    jc, tc, jp, np_params = _model("qwen2.5-3b")
    jb, tb = _both(_batch(jc, seed=3))
    params = tmodels.params_from_jax(np_params, "cpu")
    whole = tts._chunked_xent(params, tc, tb, None, False)
    chunked = tts._chunked_xent(params, tc, tb, None, False, chunk=6)
    with jax.disable_jit():
        want = jts._chunked_xent(jp, jc, jb, jmodels.ActSharding(), False,
                                 chunk=6)
    np.testing.assert_allclose(float(chunked), float(want), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers and the train step
# ---------------------------------------------------------------------------

def _opt_inputs(seed=0):
    """Parameters of every kind the models have (a stacked bf16 matrix, a
    bf16 matrix, bf16 and float32 vectors, a stacked float32 norm) and
    gradients for three steps, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": ((3, 8, 6), "bfloat16"), "w": ((8, 6), "bfloat16"),
              "b": ((6,), "bfloat16"), "norm": ((3, 8), "float32"),
              "scale": ((8,), "float32")}
    params = {k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, (s, _) in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** rng.integers(
        -3, 1) for k, (s, _) in shapes.items()} for _ in range(3)]
    return shapes, params, grads


def _as_jax(tree, shapes):
    return {k: jnp.asarray(v, getattr(jnp, shapes[k][1]))
            for k, v in tree.items()}


def _as_torch(tree, shapes):
    return {k: torch.from_numpy(v.copy()).to(getattr(torch, shapes[k][1]))
            for k, v in tree.items()}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["AdamW", "AdafactorLite"])
def test_optimizers_match_jax(name, steps):
    """One and three updates of each optimizer from the same parameters
    and gradients: parameters within a bf16 ulp, the float32 state
    (moments, or Adafactor's row and column factors) to STATE_RTOL."""
    shapes, params, grads = _opt_inputs()
    jopt, topt = getattr(joptim, name)(), getattr(toptim, name)()
    jp, tp = _as_jax(params, shapes), _as_torch(params, shapes)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for g in grads[:steps]:
        with jax.disable_jit():
            jp, jstate = jopt.update(_as_jax(g, shapes), jstate, jp)
        tp, tstate = topt.update(_as_torch(g, shapes), tstate, tp)
    assert int(tstate.step) == int(jstate.step) == steps
    for key, t, j in _pairs(tp, jp):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        np.testing.assert_allclose(_np(t), _np(j), rtol=BF16_ULP, atol=0,
                                   err_msg=key)
    for key, t, j in _pairs(tstate, jstate):
        want = _np(j)
        np.testing.assert_allclose(_np(t), want, rtol=STATE_RTOL,
                                   atol=STATE_RTOL * np.abs(want).max(),
                                   err_msg=key)
    if name == "AdafactorLite":
        assert tstate.v is None and isinstance(tstate.m["w"], tuple)


@functools.lru_cache(maxsize=None)
def _jax_train_step(microbatches, remat):
    """JAX's make_train_step on qwen2.5-3b smoke, op by op: the inputs
    and the step's outputs, as numpy."""
    jc, _, jp, np_params = _model("qwen2.5-3b")
    opt = joptim.AdamW()
    state = opt.init(jp)
    batch = _batch(jc, seed=4, b=4)
    step = jts.make_train_step(jc, opt, jts.TrainStepConfig(
        microbatches=microbatches, remat=remat))
    with jax.disable_jit():
        new_p, new_state, metrics = step(jp, state, _both(batch)[0])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (to_np(state), batch, float(metrics["loss"]), new_p, new_state)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, remat):
    """One ``make_train_step`` step (AdamW) from the same parameters,
    optimizer state and batch: the loss, the new moments, and the new
    parameters (see the module docstring for where a bf16 ulp may
    differ)."""
    jc, tc, _, np_params = _model("qwen2.5-3b")
    np_state, batch, jloss, jparams, jstate = _jax_train_step(
        microbatches, remat)
    params = tmodels.params_from_jax(np_params, "cpu")
    state = toptim.state_from_jax(np_state, "cpu")
    step = tts.make_train_step(tc, toptim.AdamW(), tts.TrainStepConfig(
        microbatches=microbatches, remat=remat))
    new_p, new_state, metrics = step(params, state, _both(batch)[1])
    assert new_p is params                    # updated in place
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert int(metrics["step"]) == int(jstate.step) == 1
    for key, t, j in _pairs(new_state.m, jstate.m):
        _close_grad(t, j, key=key)
    for key, t, j in _pairs(new_state.v, jstate.v):
        _close_grad(t, j, tol=2 * GRAD_TOL, key=key)
    for (key, t, j), (_, _, m) in zip(_pairs(new_p, jparams),
                                      _pairs(new_state.m, jstate.m)):
        m = np.abs(_np(m))
        sure = m > GRAD_TOL * m.max()
        got, want = _np(t), _np(j)
        np.testing.assert_allclose(got[sure], want[sure], rtol=BF16_ULP,
                                   atol=0, err_msg=key)
        # elsewhere a flipped sign moves the entry by at most 2 lr
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=2 * toptim.AdamW().lr, err_msg=key)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _dir_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_checkpoint_format_and_keys_match_jax(tmp_path):
    """The same parameters and AdamW state (bf16, float32 and int32
    leaves), saved by each package: the same files with the same bytes,
    manifest included (43 leaves, keys such as ``o/.step`` and
    ``o/.m/cycles/s0_attn/attn/bk``); AdafactorLite's factors are keyed by
    index (``.../bk/0``)."""
    jc, tc, jp, np_params = _model("qwen2.5-3b")
    jstate = joptim.AdamW().init(jp)
    tparams = tmodels.params_from_jax(np_params, "cpu")
    tstate = toptim.state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jckpt.CheckpointManager(str(tmp_path / "jax")).save(
        3, {"p": jp, "o": jstate}, blocking=True)
    CheckpointManager(str(tmp_path / "torch")).save(
        3, {"p": tparams, "o": tstate}, blocking=True)
    want = _dir_bytes(tmp_path / "jax" / "step_00000003")
    got = _dir_bytes(tmp_path / "torch" / "step_00000003")
    assert len(want) == 44 and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    keys = ["/".join(p) for p, _ in flatten({"p": tparams, "o": tstate})]
    assert "o/.step" in keys and "o/.m/cycles/s0_attn/attn/bk" in keys
    fac = toptim.AdafactorLite().init(tparams)
    assert "o/.m/cycles/s0_attn/attn/bk/0" in [
        "/".join(p) for p, _ in flatten({"p": tparams, "o": fac})]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restored_by_the_other_package(writer, tmp_path):
    """Parameters plus AdamW state after one update (bf16 included),
    written by one package and restored by the other: equal bytes."""
    jc, tc, jp, np_params = _model("qwen2.5-3b")
    np_state, _, _, jparams, jstate = _jax_train_step(1, False)
    jtree = {"p": jparams, "o": jstate}
    ttree = {"p": tmodels.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        "o": toptim.state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate), "cpu")}
    if writer == "jax":
        jckpt.CheckpointManager(str(tmp_path)).save(1, jtree, blocking=True)
        meta = tmodels.init_params(tc, device="meta")
        like = {"p": meta, "o": toptim.AdamW().init(meta)}
        got = CheckpointManager(str(tmp_path)).restore(1, like, "cpu")
        for (key, t, j), (_, ref, _) in zip(_pairs(got, jtree),
                                            _pairs(ttree, jtree)):
            assert t.dtype == ref.dtype, key
            assert _raw(t) == np.asarray(j).tobytes(), key
    else:
        CheckpointManager(str(tmp_path)).save(1, ttree, blocking=True)
        like = jax.eval_shape(lambda: jtree)
        got = jckpt.CheckpointManager(str(tmp_path)).restore(1, like)
        for key, t, j in _pairs(ttree, got):
            assert _raw(t) == np.asarray(j).tobytes(), key
            assert str(t.dtype).replace("torch.", "") == str(j.dtype), key


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


# ---------------------------------------------------------------------------
# the walk pipeline's unclipped first token (ROADMAP.md §3)
# ---------------------------------------------------------------------------

def test_walk_first_token_outside_the_vocabulary_gives_the_same_nan_loss():
    """The reference writes each walk's first token unclipped
    (``walks[:, 0] = cur``): over a graph with more vertices than the
    vocabulary a walk may start outside it.  JAX embeds such an id as NaN
    (``jnp.take``'s fill mode), and so does the port: the loss is NaN in
    both, from the same batch of the same pipeline."""
    jcsr, tcsr = _dblp_csrs()
    jc, tc, jp, np_params = _model("qwen2.5-3b")       # vocabulary 512
    assert tcsr.num_vertices > jc.vocab_size
    pipe = GraphWalkPipeline(csr=tcsr, label="Co-auth", batch=2, seq_len=S,
                             vocab_size=jc.vocab_size)
    batch = pipe.batch_at(0)
    jbatch = jtdata.GraphWalkPipeline(csr=jcsr, label="Co-auth", batch=2,
                                      seq_len=S,
                                      vocab_size=jc.vocab_size).batch_at(0)
    np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
    assert (batch["tokens"][:, 0] >= jc.vocab_size).any()
    assert (batch["tokens"][:, 1:] < jc.vocab_size).all()
    jb, tb = _both(batch)
    with jax.disable_jit():
        jloss = jts._chunked_xent(jp, jc, jb, jmodels.ActSharding(), False)
    tloss = tts._chunked_xent(tmodels.params_from_jax(np_params, "cpu"), tc,
                              tb, None, False)
    assert np.isnan(float(jloss)) and np.isnan(float(tloss))
