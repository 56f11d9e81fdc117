"""The port's recurrent mixers (``repro_torch.models.recurrent``) against the
JAX package's, on the CPU.

The same numpy inputs and JAX-drawn parameters go through both packages;
the JAX functions run op by op (``jax.disable_jit``), as the port does, so
every bf16 rounding happens at the same operation.  Tolerances, each with
its reason:

* float32 (every parameter and input cast to float32): rtol = atol = 1e-5.
  The projections are float32 matmuls whose sums run in another order in
  each framework, and the RG-LRU scan combines its (a, b) pairs in another
  tree (a doubling scan here, XLA's associative scan there); the states
  are O(1), so this is a few float32 ulps (measured at most 1.5e-6).
* bf16 (the models' activations; ``lam`` and the xLSTM gate weights stay
  float32, as in the models): rtol = atol = 2**-6, two bf16 ulps of the
  O(1) outputs, for outputs and float32 states alike.  Both packages round
  the same float32 values to bf16; a float32 value a few ulps apart may
  round one ulp apart, and the states sum what follows from it (measured
  at most 2**-10, on the sLSTM's output).
* A sequence against a loop of single steps, in float32, one package:
  rtol = atol = 1e-5 for the same reasons (the step's conv is one einsum,
  the sequence's four products; the scan's order is not the loop's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.recurrent as jrec
import repro_torch.models.recurrent as trec
from repro_torch.models.model import params_from_jax

F32_TOL = 1e-5
BF16_TOL = 2.0**-6
B, S, D, H = 2, 37, 32, 2           # S neither a power of two nor small
FP32_LEAVES = {"lam", "w_i", "w_f", "w_o_gate"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _params(kind, dtype):
    """JAX-drawn parameters of one mixer for both packages; in float32
    every leaf is cast, in bf16 the models' dtypes are kept."""
    key = jax.random.PRNGKey(len(kind))
    jp = {"rglru": lambda: jrec.init_rglru(key, D),
          "mlstm": lambda: jrec.init_mlstm(key, D, H),
          "slstm": lambda: jrec.init_slstm(key, D)}[kind]()
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    for name, t in tp.items():
        want = torch.float32 if (dtype == "float32" or name in FP32_LEAVES) \
            else torch.bfloat16
        assert t.dtype == want, name
    return jp, tp


def _x(rng, dtype, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _state(rng, *shape):
    """A float32 state for both packages, in memory of its own each: the
    port's mLSTM step writes its state in place, and a CPU ``jnp.asarray``
    may share the numpy buffer while JAX's dispatch is still reading it."""
    a = (rng.normal(size=shape) * 0.5).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eager(fn, *args):
    with jax.disable_jit():
        return fn(*args)


CASES = [pytest.param(dtype, init, id=f"{dtype}-{'h0' if init else 'zero'}")
         for dtype in ("float32", "bfloat16") for init in (False, True)]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype,init", CASES)
def test_rglru_seq_and_step_match_jax(dtype, init):
    rng = np.random.default_rng(1)
    jp, tp = _params("rglru", dtype)
    jx, tx = _x(rng, dtype, B, S, D)
    jh, th = _state(rng, B, D) if init else (None, None)
    jout, jlast = _eager(jrec.rglru_seq, jp, jx, jh)
    tout, tlast = trec.rglru_seq(tp, tx, th)
    assert tout.dtype == tx.dtype and tlast.dtype == torch.float32
    _close(tout, jout, _tol(dtype))
    _close(tlast, jlast, _tol(dtype))
    jconv, tconv = _x(rng, dtype, B, trec.CONV_WIDTH - 1, D)
    jh, th = _state(rng, B, D)
    jo, jhn, jc = _eager(jrec.rglru_step, jp, jx[:, 0], jh, jconv)
    to, thn, tc = trec.rglru_step(tp, tx[:, 0], th, tconv)
    _close(to, jo, _tol(dtype))
    _close(thn, jhn, _tol(dtype))
    w = trec.CONV_WIDTH - 1
    _close(tc[:, :w - 1], jc[:, :w - 1], 0.0)     # the shifted rows: exact
    # the new last row is x @ w_x, a matmul whose sums run in another
    # order in each framework, depending on the host's vector units
    _close(tc[:, w - 1], jc[:, w - 1], _tol(dtype))
    assert tc.dtype == tconv.dtype


@pytest.mark.parametrize("dtype,init", CASES)
def test_mlstm_seq_and_step_match_jax(dtype, init):
    rng = np.random.default_rng(2)
    jp, tp = _params("mlstm", dtype)
    jx, tx = _x(rng, dtype, B, S, D)
    dh = D // H
    js, ts = (None, None)
    if init:
        (jc, tc), (jn, tn) = _state(rng, B, H, dh, dh), _state(rng, B, H, dh)
        js, ts = (jc, jn), (tc, tn)
    jout, (jc, jn) = _eager(jrec.mlstm_seq, jp, jx, H, js)
    tout, (tc, tn) = trec.mlstm_seq(tp, tx, H, ts)
    assert tout.dtype == tx.dtype
    assert tc.dtype == tn.dtype == torch.float32
    _close(tout, jout, _tol(dtype))
    _close(tc, jc, _tol(dtype))
    _close(tn, jn, _tol(dtype))
    if init:                                  # the caller's state is kept
        assert not torch.equal(tc, ts[0])
    (jc, tc), (jn, tn) = _state(rng, B, H, dh, dh), _state(rng, B, H, dh)
    jo, (jc, jn) = _eager(jrec.mlstm_step, jp, jx[:, 0], (jc, jn), H)
    state = (tc, tn)
    to, (tc2, tn2) = trec.mlstm_step(tp, tx[:, 0], state, H)
    assert tc2 is tc and tn2 is tn            # updated in place
    _close(to, jo, _tol(dtype))
    _close(tc, jc, _tol(dtype))
    _close(tn, jn, _tol(dtype))


@pytest.mark.parametrize("dtype,init", CASES)
def test_slstm_seq_and_step_match_jax(dtype, init):
    rng = np.random.default_rng(3)
    jp, tp = _params("slstm", dtype)
    jx, tx = _x(rng, dtype, B, S, D)
    js, ts = (None, None)
    if init:
        pairs = [_state(rng, B, D) for _ in range(3)]
        js, ts = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    jout, jlast = _eager(jrec.slstm_seq, jp, jx, js)
    tout, tlast = trec.slstm_seq(tp, tx, ts)
    assert tout.dtype == tx.dtype
    _close(tout, jout, _tol(dtype))
    for got, want in zip(tlast, jlast):
        assert got.dtype == torch.float32
        _close(got, want, _tol(dtype))
    pairs = [_state(rng, B, D) for _ in range(3)]
    jo, jnew = _eager(jrec.slstm_step, jp, jx[:, 0],
                      tuple(p[0] for p in pairs))
    to, tnew = trec.slstm_step(tp, tx[:, 0], tuple(p[1] for p in pairs))
    _close(to, jo, _tol(dtype))
    for got, want in zip(tnew, jnew):
        _close(got, want, _tol(dtype))


def test_linear_scan_matches_a_float64_loop():
    """The doubling scan against h_t = a_t h_{t-1} + b_t in float64, at
    lengths around powers of two (the last step's partial span)."""
    rng = np.random.default_rng(4)
    for s in (1, 2, 3, 8, 9, 31, 64, 65):
        a = rng.uniform(0.5, 1.0, (B, s, 3)).astype(np.float32)
        b = rng.normal(size=(B, s, 3)).astype(np.float32)
        h = np.zeros((B, 3))
        want = np.empty((B, s, 3))
        for t in range(s):
            h = a[:, t].astype(np.float64) * h + b[:, t]
            want[:, t] = h
        got = trec.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_seq_matches_a_loop_of_steps(kind):
    """In float32, the sequence form equals its single-step form applied S
    times from the same initial state: outputs and final states."""
    rng = np.random.default_rng(5)
    _, tp = _params(kind, "float32")
    _, x = _x(rng, "float32", B, S, D)
    dh = D // H
    if kind == "rglru":
        _, h0 = _state(rng, B, D)
        out, last = trec.rglru_seq(tp, x, h0)
        h = h0
        conv = torch.zeros((B, trec.CONV_WIDTH - 1, D))
        steps = []
        for t in range(S):
            o, h, conv = trec.rglru_step(tp, x[:, t], h, conv)
            steps.append(o)
        states = [(last, h)]
    elif kind == "mlstm":
        (_, c0), (_, n0) = _state(rng, B, H, dh, dh), _state(rng, B, H, dh)
        out, (c, n) = trec.mlstm_seq(tp, x, H, (c0, n0))
        state = (c0.clone(), n0.clone())
        steps = [trec.mlstm_step(tp, x[:, t], state, H)[0]
                 for t in range(S)]
        states = [(c, state[0]), (n, state[1])]
    else:
        state = tuple(_state(rng, B, D)[1] for _ in range(3))
        out, last = trec.slstm_seq(tp, x, state)
        steps = []
        for t in range(S):
            o, state = trec.slstm_step(tp, x[:, t], state)
            steps.append(o)
        states = list(zip(last, state))
    _close(out, torch.stack(steps, dim=1), F32_TOL)
    for got, want in states:
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_loops_under_autograd_equal_the_serving_loops(kind, init):
    """When autograd records (a parameter requires a gradient), the LSTM
    sequence loops take out-of-place forms of their in-place serving loops:
    the same operations in the same order, so outputs and final states are
    bit-equal, and a backward runs through them."""
    rng = np.random.default_rng(6)
    _, tp = _params(kind, "bfloat16")
    _, x = _x(rng, "bfloat16", B, S, D)
    dh = D // H
    state = None
    if init:
        shapes = ([(B, H, dh, dh), (B, H, dh)] if kind == "mlstm"
                  else [(B, D)] * 3)
        state = tuple(_state(rng, *s)[1] for s in shapes)

    def run(p):
        if kind == "mlstm":
            return trec.mlstm_seq(p, x, H, state)
        return trec.slstm_seq(p, x, state)

    out, last = run(tp)
    grad_p = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    gout, glast = run(grad_p)
    assert gout.requires_grad
    assert torch.equal(gout.detach(), out)
    for g, w in zip(glast, last):
        assert torch.equal(g.detach(), w)
    (gout.float().sum() + sum(g.sum() for g in glast)).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in grad_p.values())
