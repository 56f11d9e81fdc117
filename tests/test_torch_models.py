"""The port's LM slice against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch``; parameters are drawn by JAX's ``init_params`` and carried
across with ``params_from_jax``.  Tolerances, each with its reason:

* Flash attention, plain version against the Pallas kernel in interpret
  mode, float32: rtol = atol = 1e-5.  Both take the same float32 inputs and
  compute in float32; they differ only in the order of the sums and in the
  online softmax's rescaling, a few ulps of values below ~5 (measured
  < 1e-6), where the reference test allows 2e-2 for its bf16-capable path.
* Layers in float32: rtol = atol = 1e-5 (sum order only), except RoPE.
  RoPE adds to its atol the move of one float32 ulp in each frequency
  (``_rope_freq_bound``): the two packages' float32 ``exp`` may round a
  frequency to a neighbouring float, depending on the host's vector
  units.  At positions up to 32k its tolerance is 2e-4 before that
  bound, because XLA's float32 sin/cos reduce their argument with an
  error that grows with it (measured 1.1e-4 at 32768 radians, 2.4e-7
  below 64).  In bf16:
  rtol = atol = 2**-6, two bf16 ulps: both round the same float32 values to
  bf16, and a float32 result a few ulps apart may round one bf16 ulp apart.
* The whole model in bf16 (the JAX package's fixed ``ACT_DTYPE``): logits
  within atol = rtol = 2.5e-2, about three bf16 ulps at |logit| ~ 1 (the
  logits' std is ~0.16).  Every matmul rounds its bf16 output once, with
  the float32 sums in another order in each framework, so hidden states
  drift by an ulp here and there (measured max 0.0078); ``test_arch_smoke``
  allows 0.15 for prefill against decode inside one framework.  The k/v
  caches (values up to ~4) are held to rtol = atol = 2**-5, two ulps.
  Decode steps are teacher-forced with JAX's argmax, so a near-tie cannot
  make the two sequences diverge.
* The MoE, recurrent and encoder-decoder families are held to the JAX
  package run op by op (``jax.disable_jit``), with the same tolerances.
  Under ``jit`` XLA fuses chains of elementwise operations and rounds
  their bf16 results at other places than the unfused program: that moves
  the fp32 router logits by up to 0.02 and flips top-k choices at near
  ties (qwen3-moe smoke: 2 of 80 (token, layer) choices, gaps 0.008, each
  moving its token's logits by O(0.3)), and the recurrences carry the
  drift into their states (sLSTM n: 0.29 after prefill and 8 steps, jit
  against op by op).  The port matches the op-by-op run exactly in most
  entries (prefill logits and caches of recurrentgemma, seamless and
  both MoE models: max |diff| 0).  The fp32 recurrent states are held
  to rtol = atol = 2**-5 (``STATE_TOL``), as the bf16 caches: they sum
  products of bf16 activations, and an activation an ulp apart upstream
  (the mLSTM's ``q^T C`` is an einsum in JAX, a matmul here, and its bf16
  output may round one ulp apart) moves them by that relative amount
  (measured 0.034 on sLSTM n after prefill).
"""
import dataclasses
import functools
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.models.config as jconfig
import repro.models.layers as jlayers
import repro.models.model as jmodel
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.models.config as tconfig
import repro_torch.models.layers as tlayers
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as kops

ROOT = Path(__file__).resolve().parents[1]
FLASH_TOL = 1e-5
F32_TOL = 1e-5
ROPE_FAR_TOL = 2e-4
BF16_TOL = 2.0**-6
LOGIT_TOL = 2.5e-2
CACHE_TOL = 2.0**-5
STATE_TOL = 2.0**-5
DENSE_ARCHS = ["gemma-2b", "qwen2.5-3b", "llama3.2-3b", "h2o-danube-3-4b",
               "internvl2-1b"]
B, S, DECODE_STEPS = 2, 20, 8        # S > h2o-danube's SMOKE window of 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy() \
            if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


def _both(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

FLASH_CASES = [
    pytest.param(sq, hq, hkv, dh, causal, window,
                 id=f"s{sq}-h{hq}x{hkv}-d{dh}-{tag}")
    for sq, hq, hkv, dh in [(128, 2, 1, 64), (256, 4, 2, 128),
                            (200, 2, 2, 32)]
    for causal, window, tag in [(True, None, "causal"), (True, 64, "win64"),
                                (False, None, "full")]
] + [pytest.param(200, 4, 2, 120, True, 64, id="s200-h4x2-d120-win64")]


@pytest.mark.parametrize("sq,hq,hkv,dh,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(sq, hq, hkv, dh, causal,
                                              window):
    rng = np.random.default_rng(sq + hq + dh)
    q, k, v = (rng.normal(size=(1, sq, h, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    got = kops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        interpret=True)
    _close(got, want, FLASH_TOL)
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                     window=window), FLASH_TOL)


def test_flash_attention_keeps_q_dtype_and_rows_without_keys():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, 2, 16)).astype(
        np.float32)).to(torch.bfloat16) for s in (12, 4, 4))
    out = kops.flash_attention(q, k, v, causal=True, window=2)
    assert out.dtype == torch.bfloat16
    # rows 5.. see no key (i - j >= 2 for every j < 4): written as 0
    assert torch.equal(out[:, 5:], torch.zeros_like(out[:, 5:]))
    want = jref.flash_attention(*(jnp.asarray(_np(t), jnp.bfloat16)
                                  for t in (q, k, v)), causal=True, window=2)
    _close(out[:, :5], np.asarray(want, np.float32)[:, :5], BF16_TOL)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="requires grad"):
        kops.flash_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(ValueError, match="multiple"):
        kops.flash_attention(q, torch.zeros(1, 8, 3, 16),
                             torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="disagree"):
        kops.flash_attention(q, k, torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError, match="want"):
        kops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="contiguous"):
        kops.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(TypeError):
        kops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="window"):
        kops.flash_attention(q, k, k, window=0)


@pytest.mark.parametrize("shape,dims,strides", [
    ((2, 5, 3, 24), (24, 3, 5, 2), (48, 144, 720)),
    ((4, 2048, 16, 128), (128, 16, 2048, 4), (256, 4096, 8388608)),
    ((1, 8192, 8, 120), (120, 8, 8192, 1), (240, 1920, 15728640)),
])
def test_tensor_map_geometry_of_the_flash_kernel(shape, dims, strides):
    """The CUDA kernel's TMA view of a (B, S, H, Dh) bf16 tensor: dims
    innermost first and the byte strides of H, S and B."""
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert tflash.tensor_map_geometry(t) == (dims, strides)


def test_tensor_map_geometry_rejects_what_a_tensor_map_cannot_take():
    with pytest.raises(ValueError, match="not contiguous"):
        tflash.tensor_map_geometry(
            torch.zeros(1, 8, 16, 2, dtype=torch.bfloat16).transpose(2, 3))
    with pytest.raises(ValueError, match="multiples of 16"):
        tflash.tensor_map_geometry(torch.zeros(1, 8, 2, 4,
                                               dtype=torch.bfloat16))


def test_flash_attention_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises, and the kernel cannot be built without nvcc."""
    meta = torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kops.flash_attention(meta, meta, meta)
    try:
        _build.nvcc_path()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.library("flash_attention")
    assert "flash_attention" in _build.SIGNATURES
    assert kops.WRAPPERS["flash_attention"] is kops.flash_attention


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rmsnorm_and_rope_match_jax(dtype, tol):
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.normal(size=(2, 7, 4, 32)), dtype)
    js, ts = _both(rng.normal(size=(32,)) * 0.1, "float32")
    _close(tlayers.rmsnorm(tx, ts), jlayers.rmsnorm(jx, js), tol)
    for high in (512, 32768):
        pos = rng.integers(0, high, (2, 7)).astype(np.int32)
        for theta in (10_000.0, 1_000_000.0):
            got = tlayers.rope(tx, torch.from_numpy(pos), theta)
            assert got.dtype == tx.dtype
            want = jlayers.rope(jx, jnp.asarray(pos), theta)
            _close_rope(got, want, tol if high == 512 else
                        max(tol, ROPE_FAR_TOL),
                        _rope_freq_bound(tx, pos, theta))


def _rope_freq_bound(x, pos, theta):
    """How far RoPE's output may move when each float32 frequency is one
    ulp apart: XLA's and torch's float32 ``exp`` round some frequencies
    to neighbouring floats on some hosts (on an AMD EPYC host 2 of 16 at
    theta 1e4, 3 of 16 at 1e6).  Frequency k one ulp off moves the angle
    by ``pos * ulp(freq_k)``, plus one ulp of the angle for the rounding
    of the product; rotating the pair (x1, x2) by an angle that far off
    moves each of its outputs by at most that angle times |(x1, x2)|."""
    half = x.shape[-1] // 2
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32) / half).numpy()
    angles = pos[..., None].astype(np.float32) * freqs      # (B, S, half)
    dangle = pos[..., None] * np.spacing(freqs) + np.spacing(angles)
    xf = _np(x)
    radius = np.hypot(xf[..., :half], xf[..., half:])       # (B,S,H,half)
    move = dangle[..., None, :] * radius
    return np.concatenate([move, move], axis=-1)


def _close_rope(got, want, tol, bound):
    """``_close`` with ``bound`` (elementwise) added to its atol."""
    got, want = _np(got), _np(want)
    excess = np.abs(got - want) - (tol + tol * np.abs(want) + bound)
    assert excess.max() <= 0, f"over the bound by {excess.max()}"


def _attn_inputs(rng, b, sq, sk, hq, hkv, dh, dtype):
    return [_both(rng.normal(size=(b, s, h, dh)), dtype)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("case", ["causal", "window", "kv_valid", "decode",
                                  "cross"])
def test_attention_matches_jax(case, dtype, tol):
    rng = np.random.default_rng(len(case))
    b, sq, sk = 2, 12, 12
    if case == "decode":
        sq, sk = 1, 16
    elif case == "cross":
        sk = 9
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(rng, b, sq, sk, 4, 2, 16,
                                                dtype)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))
    kw = {"causal": case != "cross"}
    if case == "window":
        kw["window"] = 4
    if case in ("kv_valid", "decode"):
        valid = rng.random((b, sk)) < 0.7
        valid[:, 0] = True
        if case == "decode":
            q_pos = np.full((b, 1), sk - 1, np.int32)
            kw["window"] = 6
        kw_j = dict(kw, kv_valid=jnp.asarray(valid))
        kw_t = dict(kw, kv_valid=torch.from_numpy(valid))
    else:
        kw_j = kw_t = kw
    got = tlayers.attention(tq, tk, tv, torch.from_numpy(q_pos.copy()),
                            torch.from_numpy(k_pos.copy()), **kw_t)
    want = jlayers.attention(jq, jk, jv, jnp.asarray(q_pos),
                             jnp.asarray(k_pos), **kw_j)
    assert got.dtype == tq.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("case", ["causal", "window", "kv_valid"])
def test_chunked_attention_matches_dense_and_jax(case, monkeypatch):
    """Small chunks (8) over S = 20, so the padding path runs; and
    ``attention`` routes to the chunked path above ``CHUNK_THRESHOLD``."""
    rng = np.random.default_rng(7)
    b, s = 2, 20
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(rng, b, s, s, 4, 1, 16,
                                                "float32")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw = {"causal": True, "window": 5 if case == "window" else None}
    valid = None
    if case == "kv_valid":
        valid = rng.random((b, s)) < 0.8
        valid[:, 0] = True
    tkw = dict(kw, kv_valid=None if valid is None else torch.from_numpy(
        valid))
    jkw = dict(kw, kv_valid=None if valid is None else jnp.asarray(valid))
    tpos = torch.from_numpy(pos)
    dense = tlayers.attention(tq, tk, tv, tpos, tpos, **tkw)
    chunked = tlayers.chunked_attention(tq, tk, tv, tpos, tpos, q_chunk=8,
                                        k_chunk=8, **tkw)
    _close(chunked, dense, F32_TOL)
    want = jlayers.chunked_attention(jq, jk, jv, jnp.asarray(pos),
                                     jnp.asarray(pos), q_chunk=8, k_chunk=8,
                                     **jkw)
    _close(chunked, want, F32_TOL)
    monkeypatch.setattr(tlayers, "CHUNK_THRESHOLD", s - 1)
    routed = tlayers.attention(tq, tk, tv, tpos, tpos, **tkw)
    _close(routed, dense, F32_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_gated_mlp_matches_jax(kind, dtype, tol):
    rng = np.random.default_rng(11)
    jx, tx = _both(rng.normal(size=(2, 5, 32)), dtype)
    jp, tp = {}, {}
    for name, shape in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                        ("w_down", (48, 32))):
        jp[name], tp[name] = _both(rng.normal(size=shape) / np.sqrt(
            shape[0]), dtype)
    got = tlayers.gated_mlp(tx, tp, kind)
    assert got.dtype == tx.dtype
    _close(got, jlayers.gated_mlp(jx, jp, kind), 2 * tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jc = getattr(jconfigs, get)(arch)
        tc = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert tc.layer_kinds() == jc.layer_kinds()
        assert (tc.q_dim, tc.kv_dim) == (jc.q_dim, jc.kv_dim)


def test_registry_and_shapes_match_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {a: dataclasses.asdict(c)
            for a, c in tconfigs.all_configs().items()} == \
        {a: dataclasses.asdict(c) for a, c in jconfigs.all_configs().items()}
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert tconfig.SHAPES["train_4k"].tokens == 4096 * 256
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_meta_params_match_abstract_params(arch):
    """Full size, no allocation: the port's tree has JAX's keys, shapes and
    dtypes, and so exactly its parameter count."""
    cfg = tconfigs.get_config(arch)
    got = _leaves(tmodels.init_params(cfg, device="meta"))
    want = _leaves(jmodels.abstract_params(jconfigs.get_config(arch)))
    assert got.keys() == want.keys()
    for key, t in got.items():
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert str(t.dtype).replace("torch.", "") == str(want[key].dtype), key
    n = sum(t.numel() for t in got.values())
    assert n == sum(int(np.prod(a.shape)) for a in want.values())
    if arch in DENSE_ARCHS:
        # ArchConfig.n_params counts the attention biases and patch_proj
        # out; for the recurrent kinds, the router and the encoder it is
        # an approximation, so those are held to the exact count alone
        assert abs(n - cfg.n_params()) <= cfg.num_layers * 3 * cfg.q_dim \
            + cfg.d_model ** 2


def test_expert_parallel_moe_raises():
    """The expert-parallel MoE (``moe_mesh``) serves
    (``tests/test_torch_moe_ep.py`` holds it against JAX), and the training
    step takes it now (the sharded train step over ``DTensor`` state,
    ``tests/test_torch_train_sharded.py``): ``make_train_step`` accepts
    every such ``ActSharding`` and raises nothing; there is no
    ``check_unsharded`` left."""
    import repro_torch.models.model as tmodel
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import make_train_step

    tc = tconfigs.get_smoke_config("qwen3-moe-235b-a22b")
    for sh in (tmodels.ActSharding(moe_mesh="m"),
               tmodels.ActSharding(moe_mesh="m", moe_dp_axes=("data",))):
        assert callable(make_train_step(tc, AdamW(), sh=sh))
    assert not hasattr(tmodel, "check_unsharded")


# ---------------------------------------------------------------------------
# the slice: forward, prefill, decode against the JAX package
# ---------------------------------------------------------------------------

def _max_len(jc):
    extra = jc.frontend_len if jc.frontend == "patch" else 0
    return S + extra + DECODE_STEPS + 2


def _batches(jc, rng):
    """One seeded batch for both packages: tokens, plus the patch
    frontend's embeddings or the encoder's frames."""
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = {"patch": "embeds", "frames": "frames"}.get(jc.frontend)
    if extra:
        e = rng.normal(size=(B, jc.frontend_len, jc.d_model)).astype(
            np.float32)
        jb[extra], tb[extra] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """JAX parameters, the port's copy of them, one seeded batch, and the
    JAX package's forward logits and prefill (one jit for both)."""
    jc = jconfigs.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tp = tmodels.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    jb, tb = _batches(jc, np.random.default_rng(0))
    jout = _jax(arch, lambda p, b: (
        jmodels.forward(p, jc, b),
        jmodels.prefill(p, jc, b, max_len=_max_len(jc))))(jp, jb)
    return jc, tc, jp, tp, jb, tb, jout


def _jax(arch, fn):
    """The JAX package's ``fn`` as the parity tests run it: jitted for the
    dense families, op by op (``jax.disable_jit``) for the others (see
    the module docstring)."""
    if arch in DENSE_ARCHS:
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def test_params_from_jax_keeps_the_tree():
    """Every leaf of every family, the fp32 ones (``lam``, the xLSTM gates,
    ``w_router``), the stacked encoder layers and ``xattn``/``norm_x``
    included, crosses with its key, shape, dtype and bits."""
    for arch in jconfigs.ARCH_IDS:
        _check_tree(arch)


def _check_tree(arch):
    jc, tc, jp, tp, _, _, _ = _setup(arch)
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for key, t in tl.items():
        want = np.asarray(jl[key])
        assert tuple(t.shape) == want.shape, key
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), key
        # bf16 bits carried across unchanged
        np.testing.assert_array_equal(_np(t), want.astype(np.float32))
    pat = jc.block_pattern
    assert tl[f"/cycles/s0_{pat[0]}/norm1"].shape[0] == \
        jc.num_layers // len(pat)
    fp32 = {"rglru": ["lam"], "mlstm": ["w_i", "w_f"],
            "slstm": ["w_i", "w_f", "w_o_gate"]}
    for j, kind in enumerate(pat):
        for name in fp32.get(kind, []):
            assert tl[f"/cycles/s{j}_{kind}/{kind}/{name}"].dtype == \
                torch.float32
    if jc.moe is not None:
        assert tl["/cycles/s0_attn/ffn/w_router"].dtype == torch.float32
    if jc.encoder is not None:
        assert tl["/encoder/layers/attn/wq"].shape[0] == \
            jc.encoder.num_layers
        assert "/cycles/s0_attn/xattn/wq" in tl
        assert "/cycles/s0_attn/norm_x" in tl


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_matches_jax(arch):
    jc, tc, jp, tp, jb, tb, (want, _) = _setup(arch)
    got = tmodels.forward(tp, tc, tb)
    extra = jc.frontend_len if jc.frontend == "patch" else 0
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, S + extra, jc.vocab_size)
    _close(got, want, LOGIT_TOL)


def _close_cache(got, want):
    """Every entry of one layer cache: bf16 k/v/conv/xk/xv to CACHE_TOL,
    fp32 recurrent states to STATE_TOL (see the module docstring)."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(w.dtype), key
        _close(got[key], w, STATE_TOL if w.dtype == jnp.float32
               else CACHE_TOL)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp, jb, tb, (_, (jlog, jcache)) = _setup(arch)
    extra = jc.frontend_len if jc.frontend == "patch" else 0
    tlog, tcache = tmodels.prefill(tp, tc, tb, _max_len(jc))
    _close(tlog, jlog, LOGIT_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + extra
    assert tcache["pos"].dtype == torch.int32
    assert tcache.keys() == jcache.keys()
    assert tcache["cycles"].keys() == jcache["cycles"].keys()

    def close_caches():
        for slot, lc in jcache["cycles"].items():
            _close_cache(tcache["cycles"][slot], lc)
        for key in jcache:
            if key.startswith("tail_"):
                _close_cache(tcache[key], jcache[key])
        if "enc_out" in jcache:
            _close(tcache["enc_out"], jcache["enc_out"], CACHE_TOL)

    close_caches()
    step = _jax(arch, lambda p, c, t: jmodels.decode_step(p, jc, c, t))
    for i in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        jlog, jcache = step(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tmodels.decode_step(tp, tc, tcache,
                                           torch.from_numpy(tok))
        assert tuple(tlog.shape) == (B, jc.vocab_size), i
        _close(tlog, jlog, LOGIT_TOL)
    assert int(tcache["pos"]) == S + extra + DECODE_STEPS
    close_caches()                  # the ring buffer wrapped


def test_encode_matches_jax():
    """seamless-m4t's encoder alone: non-causal self-attention over the
    frames, then the final norm (bf16, to the cache tolerance)."""
    jc, tc, jp, tp, jb, tb, _ = _setup("seamless-m4t-medium")
    want, _ = _jax("seamless-m4t-medium", lambda p, f: jmodel._encode(
        p, jc, f, jmodel.ActSharding()))(jp, jb["frames"])
    got = tmodel._encode(tp, tc, tb["frames"])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (B, jc.frontend_len, jc.d_model)
    _close(got, want, CACHE_TOL)


def test_prefill_rejects_a_prompt_shorter_than_the_conv_tail():
    """The reference's RG-LRU prefill leaves a short conv cache for a
    prompt under CONV_WIDTH - 1 tokens, and its next decode step fails on
    it; the port refuses the prompt, and takes three tokens."""
    jc, tc, jp, tp, *_ = _setup("recurrentgemma-9b")
    for s in (1, 2):
        toks = torch.zeros((B, s), dtype=torch.int32)
        with pytest.raises(ValueError, match="conv"):
            tmodels.prefill(tp, tc, {"tokens": toks}, 8)
        _, jcache = jmodels.prefill(jp, jc, {"tokens": jnp.asarray(
            toks.numpy())}, max_len=8)
        assert jcache["cycles"]["s0_rglru"]["conv"].shape[2] == s
    toks = np.arange(3 * B, dtype=np.int32).reshape(B, 3)
    tlog, _ = tmodels.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 8)
    jlog, _ = jmodels.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                              max_len=8)
    _close(tlog, jlog, LOGIT_TOL)


def test_decode_past_the_end_of_the_cache_matches_jax():
    """Past the end of an ``attn`` cache both packages overwrite its last
    slot: max_len 4, a prompt of 4, two decode steps."""
    jc, tc, jp, tp, *_ = _setup("qwen2.5-3b")
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, 4)).astype(
        np.int32)
    jlog, jcache = jmodels.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                                   max_len=4)
    tlog, tcache = tmodels.prefill(tp, tc, {"tokens": torch.from_numpy(toks)},
                                   4)
    step = jax.jit(lambda p, c, t: jmodels.decode_step(p, jc, c, t))
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        jlog, jcache = step(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tmodels.decode_step(tp, tc, tcache,
                                           torch.from_numpy(tok))
        assert bool(torch.isfinite(tlog).all())
        _close(tlog, jlog, LOGIT_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 6
    for slot, lc in jcache["cycles"].items():
        _close(tcache["cycles"][slot]["k"], lc["k"], CACHE_TOL)


def test_kernel_path_on_the_cpu_takes_the_plain_flash_version():
    """``use_kernel=True`` on CPU tensors goes through the wrapper, which
    takes its float32 plain version: no launch, and the logits agree with
    the plain attention (bf16 probabilities) to the model tolerance."""
    _, tc, _, tp, _, tb, _ = _setup("h2o-danube-3-4b")
    kops.reset_launch_counts()
    plain = tmodels.forward(tp, tc, tb)
    via_wrapper = tmodels.forward(tp, tc, tb, use_kernel=True)
    logits, _ = tmodels.prefill(tp, tc, tb, S + 4, use_kernel=True)
    assert kops.launch_counts()["flash_attention"] == 0
    _close(via_wrapper, plain, LOGIT_TOL)
    _close(logits, plain[:, -1], LOGIT_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "seamless-m4t-medium",
                                  "qwen3-moe-235b-a22b"])
def test_every_attention_goes_through_the_flash_wrapper(arch, monkeypatch):
    """``use_kernel=True`` sends every full-sequence attention through the
    flash wrapper (windowed MQA, the encoder's non-causal self-attention,
    cross-attention with Sq != Sk); on CPU tensors it takes its float32
    plain version, and the logits agree with the plain path."""
    jc, tc, _, tp, _, tb, _ = _setup(arch)
    calls = []
    wrapper = kops.flash_attention

    def spy(q, k, v, causal=True, window=None):
        calls.append((q.shape[1], k.shape[1], causal, window))
        return wrapper(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(kops, "flash_attention", spy)
    with tmoe.recording_routes() as plain_routes:
        plain = tmodels.forward(tp, tc, tb)
    assert not calls
    with tmoe.recording_routes() as fast_routes:
        fast = tmodels.forward(tp, tc, tb, use_kernel=True)
    agree = torch.ones(B * S, dtype=torch.bool)
    if jc.moe is not None:
        # the wrapper keeps its probabilities in float32, the plain path
        # rounds them to bf16: near-tie routing may flip (module docstring)
        _, agree = tmoe.route_changes(fast_routes, plain_routes)
        assert float(agree.float().mean()) >= 0.9
    agree = agree.reshape(B, S)
    _close(fast[agree], plain[agree], LOGIT_TOL)
    n_attn = sum(k in ("attn", "swa") for k in jc.layer_kinds())
    enc = jc.encoder.num_layers if jc.encoder else 0
    assert len(calls) == n_attn + enc + (n_attn if jc.encoder else 0)
    src = jc.frontend_len
    if arch == "seamless-m4t-medium":
        assert calls[:enc] == [(src, src, False, None)] * enc
        assert calls[enc:] == [(S, S, True, None), (S, src, False, None)] \
            * n_attn
    elif arch == "recurrentgemma-9b":
        assert set(calls) == {(S, S, True, jc.window)}
    else:
        assert set(calls) == {(S, S, True, None)}
    calls.clear()
    logits, _ = tmodels.prefill(tp, tc, tb, _max_len(jc), use_kernel=True)
    assert len(calls) == n_attn + enc + (n_attn if jc.encoder else 0)
    last = agree[:, -1]
    assert bool(last.any())
    _close(logits[last], plain[:, -1][last], LOGIT_TOL)


def test_sharded_activations_raise():
    """Activation placements change no value (JAX: sharding constraints):
    ``forward`` with them equals ``forward`` without and records each one;
    the training step takes them, and on one device's tensors its step
    equals the step without them."""
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import make_train_step

    _, tc, _, tp, _, tb, _ = _setup("qwen2.5-3b")
    dp = ("data",)
    sh = tmodels.ActSharding(hidden=(dp, None, None),
                             heads=(dp, None, "model", None),
                             logits=(dp, None, "model"))
    with tlayers.recording_placements() as placed:
        got = tmodels.forward(tp, tc, tb, sh=sh)
    assert torch.equal(got, tmodels.forward(tp, tc, tb))
    assert {field for field, *_ in placed} == {"hidden", "heads", "logits"}
    assert ("logits", sh.logits, tuple(got.shape), torch.float32) in placed
    batch = {"tokens": tb["tokens"][:, :-1], "labels": tb["tokens"][:, 1:]}
    outs = []
    for placed_sh in (tmodels.ActSharding(hidden="x"), sh, None):
        params = tmodels.init_params(tc, torch.Generator().manual_seed(1),
                                     "cpu")
        opt = AdamW()
        step = make_train_step(tc, opt, sh=placed_sh)
        outs.append(step(params, opt.init(params), batch))
    for new_p, _, metrics in outs[:2]:
        assert torch.equal(metrics["loss"], outs[2][2]["loss"])
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(new_p).values(), _leaves(outs[2][0]).values()))
    assert tmodels.forward(tp, tc, tb, sh=tmodels.ActSharding()).shape[1] \
        == S


def test_init_params_draws_seeded_weights():
    cfg = tconfigs.get_smoke_config("gemma-2b")
    a = tmodels.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = tmodels.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    la, lb = _leaves(a), _leaves(b)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    wq = la["/cycles/s0_attn/attn/wq"]
    assert not torch.equal(wq[0], wq[1])             # cycles drawn apart
    assert abs(float(wq.float().std()) * np.sqrt(cfg.d_model) - 1) < 0.1
    with pytest.raises(ValueError, match="Generator"):
        tmodels.init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the example and the import contract
# ---------------------------------------------------------------------------

def _run_example(monkeypatch, capsys, *args):
    """``examples/serve_lm_torch.py`` in this process (argv patched)."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["serve_lm_torch.py", *args])
    runpy.run_path(str(ROOT / "examples" / "serve_lm_torch.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def test_serve_lm_torch_runs_on_the_cpu(monkeypatch, capsys):
    out = _run_example(monkeypatch, capsys, "--device", "cpu", "--tokens",
                       "6", "--batch", "2")
    lines = out.strip().splitlines()
    assert "sample generations" in out
    assert lines[-3].startswith("prefill:") and lines[-3].endswith("cpu")
    assert lines[-2].startswith("decode :")
    result = json.loads(lines[-1])
    assert result["arch"] == "qwen2.5-3b-smoke" and result["device"] == "cpu"
    assert result["decode_ms_per_step"] > 0


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS
                                  if a not in DENSE_ARCHS])
def test_serve_lm_torch_serves_every_family(arch, monkeypatch, capsys):
    """The example takes any ARCH_ID; seamless gets its encoder's frames
    from numpy's seed; ``--layers`` cuts the depth."""
    out = _run_example(monkeypatch, capsys, "--device", "cpu", "--arch",
                       arch, "--tokens", "3", "--batch", "2", "--layers",
                       "2")
    result = json.loads(out.strip().splitlines()[-1])
    assert result["arch"] == f"{arch}-smoke"
    assert "layers=2" in out and result["decode_ms_per_step"] > 0


def test_serve_lm_torch_defaults_to_the_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run_example(monkeypatch, capsys, "--tokens", "2")


# ---------------------------------------------------------------------------
# token ids outside [-V, V): NaN rows, as jnp.take's fill mode gives them
# ---------------------------------------------------------------------------

def _recording_jax_routes(monkeypatch):
    """Record, for every JAX ``moe_ffn`` call, each token's reached experts
    (-1 for a choice dropped at capacity), from the reference's own
    dispatch (``_local_dispatch`` is ``moe_ffn``'s routing, line for
    line)."""
    import repro.models.moe as jmoe
    routes, real = [], jmodel.moe_ffn

    def recording(x, p, spec, *args, **kwargs):
        t, k = x.shape[0], spec.top_k
        logits = x.astype(jnp.float32) @ p["w_router"]
        cap = jmoe.capacity_for(t, spec)
        _, st, slot, keep, _ = jmoe._local_dispatch(x, logits, spec, cap)
        st, slot, keep = (np.asarray(a) for a in (st, slot, keep))
        reached = [[] for _ in range(t)]
        for tok, sl, kept in zip(st, slot, keep):
            reached[tok].append(int(sl) // cap if kept else -1)
        routes.append(np.sort(np.array(reached).reshape(t, k), axis=1))
        return real(x, p, spec, *args, **kwargs)

    monkeypatch.setattr(jmodel, "moe_ffn", recording)
    return routes


def _same_nan_and_close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("bad", ["V", "V+5", "-1", "-V-1"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_token_ids_out_of_range_match_jax(arch, bad, monkeypatch):
    """An id outside [-V, V) embeds as NaN in both packages (JAX:
    ``jnp.take``'s fill mode; the port used to raise), an id in [-V, 0)
    counts from the end.  Row 0 holds the id at position 3 and row 1 none,
    through ``forward``, ``prefill`` and two ``decode_step`` calls, against
    JAX run op by op.  A NaN row's keys and values reach every query of
    that row (0 x NaN in the probabilities' product), so all of row 0 is
    NaN in both.  In the MoE models NaN router logits decide which experts
    those tokens take (``lax.top_k`` ranks NaN first, lowest index first):
    each call's routes are recorded in both packages and must match, and
    llama4-scout's capacity (16 slots for 40 choices) makes row 0's NaN
    tokens push row 1's tokens out of expert 0 in both."""
    jc, tc, jp, tp, *_ = _setup(arch)
    v = jc.vocab_size
    bad_id = {"V": v, "V+5": v + 5, "-1": -1, "-V-1": -v - 1}[bad]
    toks = np.random.default_rng(9).integers(0, v, (B, S)).astype(np.int32)
    toks[0, 3] = bad_id
    jroutes = _recording_jax_routes(monkeypatch)
    with tmoe.recording_routes() as troutes, jax.disable_jit():
        jb, tb = {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks.copy())}
        want = jmodels.forward(jp, jc, jb)
        got = tmodels.forward(tp, tc, tb)
        _same_nan_and_close(got, want)
        assert np.isnan(_np(got)[0]).all() == (bad != "-1")
        assert np.isfinite(_np(got)[1]).all()

        jlog, jcache = jmodels.prefill(jp, jc, jb, max_len=S + 4)
        tlog, tcache = tmodels.prefill(tp, tc, tb, S + 4)
        _same_nan_and_close(tlog, jlog)
        for first in (bad_id, 7):               # the NaN stays in the cache
            tok = np.array([first, 5], np.int32)
            jlog, jcache = jmodels.decode_step(jp, jc, jcache,
                                               jnp.asarray(tok))
            tlog, tcache = tmodels.decode_step(tp, tc, tcache,
                                               torch.from_numpy(tok))
            _same_nan_and_close(tlog, jlog)
            assert np.isnan(_np(tlog)[0]).all() == (bad != "-1")
    if jc.moe is None:
        return
    assert len(troutes) == len(jroutes) == 4 * jc.num_layers
    for t, j in zip(troutes, jroutes):
        np.testing.assert_array_equal(np.sort(t.numpy(), axis=1), j)
    if bad != "-1":              # row 0's NaN tokens take experts 0..k-1
        k = jc.moe.top_k
        first = np.sort(troutes[0].numpy(), axis=1)[:S]
        assert set(first[first >= 0].tolist()) <= set(range(k))
        if arch.startswith("llama4"):
            assert (troutes[0].numpy()[S:] == -1).any()
