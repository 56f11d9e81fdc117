"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

The same numpy tokens and JAX-drawn expert weights go through both
packages; the JAX function runs op by op (``jax.disable_jit``), as the port
does.  The tokens are normal draws, so no two router logits of a token tie:
``torch.topk`` does not promise ``lax.top_k``'s lowest-index order among
equal values, and the tests do not ask it to.  Tolerances, each with its
reason:

* float32 (weights and tokens cast to float32): rtol = 1e-5 and atol =
  1e-5 x max |output|, a few float32 ulps: the expert products and the
  router are float32 matmuls whose sums run in another order.  The atol
  scales with the output because the reference's expert weights are
  (E, D, F) and ``dense_init`` scales them by 1/sqrt(E), so outputs reach
  O(100) at these widths, and where an expert's and the shared expert's
  outputs cancel the error is the terms' ulps, not the result's.
* bf16 (the models' dtypes; the router stays float32): rtol = atol =
  2**-6, two bf16 ulps: both round the same float32 sums to bf16 (measured
  equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as jmoe
import repro_torch.configs as tconfigs
import repro_torch.models.moe as tmoe
from repro_torch.models.model import params_from_jax

F32_TOL = 1e-5
BF16_TOL = 2.0**-6
ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _specs(arch):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return jc, jc.moe, tc.moe


def _setup(arch, dtype, tokens, seed=0):
    jc, jspec, tspec = _specs(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc.d_model, jspec)
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    assert tp["w_router"].dtype == torch.float32
    x = np.random.default_rng(seed).normal(
        size=(tokens, jc.d_model)).astype(np.float32)
    return (jp, jnp.asarray(x, getattr(jnp, dtype)),
            tp, torch.from_numpy(x).to(getattr(torch, dtype)))


def _close_f32(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                               atol=F32_TOL * max(1.0, np.abs(want).max()))


def _run_both(jspec, tspec, jp, jx, tp, tx):
    with jax.disable_jit():
        want = jmoe.moe_ffn(jx, jp, jspec)
    got = tmoe.moe_ffn(tx, tp, tspec)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    return got, want


@pytest.mark.parametrize("tokens", [1, 4, 40, 1000, 8192])
@pytest.mark.parametrize("arch", ARCHS + ["full"])
def test_capacity_for_matches_jax(arch, tokens):
    if arch == "full":
        for a in ARCHS:
            spec = jconfigs.get_config(a).moe
            assert tmoe.capacity_for(tokens, tconfigs.get_config(a).moe) \
                == jmoe.capacity_for(tokens, spec)
        return
    _, jspec, tspec = _specs(arch)
    assert tmoe.capacity_for(tokens, tspec) == jmoe.capacity_for(tokens,
                                                                 jspec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype):
    """The smoke specs: qwen3-moe's 8 experts top-2, llama4-scout's 4
    experts top-1 with its shared expert."""
    jc, jspec, tspec = _specs(arch)
    jp, jx, tp, tx = _setup(arch, dtype, 40)
    assert ("w_shared_gate" in tp) == bool(tspec.shared_expert_dim)
    got, want = _run_both(jspec, tspec, jp, jx, tp, tx)
    if dtype == "float32":
        _close_f32(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def _per_token(x, p, spec):
    """float32 MoE, token by token: each (token, k) assignment in
    flattened order takes a place at its expert while the expert has fewer
    than ``capacity_for`` of them (the stable sort's rule); kept ones add
    their gated expert output, then the shared expert."""
    t = x.shape[0]
    cap = tmoe.capacity_for(t, spec)
    idx, gates = tmoe.route(x, p["w_router"], spec.top_k)
    used = [0] * spec.num_experts
    out = torch.zeros(x.shape, dtype=torch.float32)
    kept = 0
    for i in range(t):
        for j in range(spec.top_k):
            e = int(idx[i, j])
            if used[e] == cap:
                continue
            used[e] += 1
            kept += 1
            h = torch.nn.functional.silu(x[i] @ p["w_gate"][e]) \
                * (x[i] @ p["w_up"][e])
            out[i] += gates[i, j] * (h @ p["w_down"][e])
    if spec.shared_expert_dim:
        h = torch.nn.functional.silu(x @ p["w_shared_gate"]) \
            * (x @ p["w_shared_up"])
        out += h @ p["w_shared_down"]
    return out, kept


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_what_jax_drops(arch):
    """Capacity factor 0.25 over 256 tokens: hot experts overflow, and each
    keeps its first (token, k) assignments in token order.  The port, JAX
    and a token-by-token version agree."""
    jc, jspec, tspec = _specs(arch)
    jspec = dataclasses.replace(jspec, capacity_factor=0.25)
    tspec = dataclasses.replace(tspec, capacity_factor=0.25)
    t = 256
    jp, jx, tp, tx = _setup(arch, "float32", t, seed=1)
    want, kept = _per_token(tx, tp, tspec)
    assert kept < t * tspec.top_k, "the case must drop"
    got, jwant = _run_both(jspec, tspec, jp, jx, tp, tx)
    _close_f32(got, jwant)
    _close_f32(got, want)


def test_route_matches_lax_top_k():
    _, jspec, tspec = _specs("qwen3-moe-235b-a22b")
    jp, jx, tp, tx = _setup("qwen3-moe-235b-a22b", "float32", 64)
    idx, gates = tmoe.route(tx, tp["w_router"], tspec.top_k)
    logits = jnp.asarray(jx) @ jp["w_router"]
    vals, jidx = jax.lax.top_k(logits, jspec.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(),
                               np.asarray(jax.nn.softmax(vals, axis=-1)),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_recorded_routes_mark_drops_and_changes():
    """``recording_routes`` keeps each call's reached experts (-1 where a
    choice was dropped at capacity); ``route_changes`` counts the choices
    one run made that the other did not, and masks the tokens that agree
    in every call."""
    _, _, tspec = _specs("llama4-scout-17b-a16e")
    tspec = dataclasses.replace(tspec, capacity_factor=0.25)
    _, _, tp, tx = _setup("llama4-scout-17b-a16e", "float32", 256, seed=1)
    with tmoe.recording_routes() as first:
        tmoe.moe_ffn(tx, tp, tspec)
        with tmoe.recording_routes() as inner:
            tmoe.moe_ffn(tx[:64], tp, tspec)
    assert len(first) == 1 and len(inner) == 1
    idx, _ = tmoe.route(tx, tp["w_router"], 1)
    reached = first[0]
    assert reached.shape == (256, 1)
    kept = reached[:, 0] >= 0
    assert torch.equal(reached[kept], idx[kept])
    _, n_kept = _per_token(tx, tp, tspec)
    assert int(kept.sum()) == n_kept and not bool(kept.all())
    # moving one token elsewhere: one choice differs, one token disagrees
    other = reached.clone()
    other[0, 0] = (other[0, 0] + 1) % tspec.num_experts
    counts, agree = tmoe.route_changes([reached, reached], [reached, other])
    assert counts == [0, 1]
    assert not bool(agree[0]) and bool(agree[1:].all())
    with pytest.raises(ValueError, match="other calls"):
        tmoe.route_changes([reached], [reached, other])
