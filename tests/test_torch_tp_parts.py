"""Tensor-parallel serving, continued (``tests/test_torch_tp_serve.py``
holds the dense cases and the harness this file reuses): the MoE and
encoder-decoder cases against the JAX package, the pieces alone on ranks
of a ``gloo`` world of 2, and the flash kernel's query offset.

* qwen3-moe-235b-a22b smoke at ``model`` 2: attention split by heads, the
  embedding and head by vocabulary, the experts expert-parallel
  (``moe_ffn_shard_map``); seamless-m4t-medium smoke at ``model`` 2: the
  encoder's and the decoder's attention split by heads, the decoder's
  cross-attention caches ``xk``/``xv`` split by KV heads.  Both against
  the JAX package's jitted prefill and decode steps under the same
  placements, to ``LOGIT_TOL`` / ``CACHE_TOL``.  The MoE's reference is
  JAX's own GSPMD run: the port now splits the dense layers as GSPMD does
  (by heads, closed by one sum), so the hidden states the router sees
  agree and every route with them (measured: logits within 0.0020 and the
  caches within 0.0079 of JAX's; against the port's unsharded run the
  logits move by 0.0084).  A flipped near-tie would move its token's
  logits by O(0.3) (``tests/test_torch_train_sharded.py``'s docstring),
  far outside the tolerance.  seamless: within 1.9e-6 of JAX.
* ``mesh_axes.psum`` alone at world 2 against the sum computed whole, and
  its adjoint (the identity: every rank computes the one loss from the
  sum); ``decode.dh_sharded_attention`` (the head_dim-sharded decode
  attention with its two ``all_to_all`` exchanges) against
  ``layers.attention`` on the whole tensors, with heads split and whole.
* The flash kernel's plain version with ``q_offset``: against the JAX
  package's ``attention`` with the query positions shifted, and equal to
  the rows of the unshifted run it stands for; offset 0 equal, bit for
  bit, to the call without it.
"""
import numpy as np
import pytest
import torch

import test_torch_tp_serve as serve

CASES = [("qwen3-moe-235b-a22b", "1x2"), ("seamless-m4t-medium", "1x2")]
FLASH_TOL = 1e-5

EXTRA = r"""
# the pieces alone, over the 2 ranks of a 1x2 mesh's model axis
if world == 2:
    mesh = meshes.get("1x2") or init_device_mesh(
        "cpu", (1, 2), mesh_dim_names=("data", "model"))
    group = axis_group(mesh, "model")
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(2, 3, 4, generator=gen, dtype=torch.float64)
    c = torch.randn(3, 4, generator=gen, dtype=torch.float64)
    x = xs[rank].clone().requires_grad_()
    y = psum(x, group)
    (c * y ** 2).sum().backward()
    out[f"psum/y/{rank}"] = y.detach().numpy()
    out[f"psum/grad/{rank}"] = x.grad.numpy()
    xb = xs[rank].to(torch.bfloat16)
    out[f"psum/bf16/{rank}"] = psum(xb, group).to(torch.float64).numpy()

    from repro_torch.models.config import ArchConfig
    from repro_torch.models.decode import dh_sharded_attention
    from repro_torch.models.layers import attention
    from repro_torch.models.model import tp_of
    from repro_torch.launch.sharding import act_sharding
    tp = tp_of(act_sharding(tconfigs.get_smoke_config("qwen2.5-3b"), mesh, 2))
    for hq, hkv in ((4, 2), (4, 1)):
        acfg = ArchConfig(name="a", family="dense", num_layers=1, d_model=64,
                          num_heads=hq, num_kv_heads=hkv, head_dim=16,
                          d_ff=64, vocab_size=64)
        b, sk = 2, 12
        q = torch.randn(b, 1, hq, 16, generator=gen).to(torch.bfloat16)
        k = torch.randn(b, sk, hkv, 16, generator=gen).to(torch.bfloat16)
        v = torch.randn(b, sk, hkv, 16, generator=gen).to(torch.bfloat16)
        qp = torch.full((b, 1), 9, dtype=torch.int32)
        kp = torch.arange(sk, dtype=torch.int32).expand(b, sk)
        valid = kp <= 9
        want = attention(q, k, v, qp, kp, causal=True, kv_valid=valid)
        for split in (True, False):
            qm = q[:, :, rank * hq // 2:(rank + 1) * hq // 2] if split else q
            got = dh_sharded_attention(
                qm, k[..., rank * 8:(rank + 1) * 8].contiguous(),
                v[..., rank * 8:(rank + 1) * 8].contiguous(), qp, kp, True,
                None, valid, acfg, tp)
            w = want[:, :, rank * hq // 2:(rank + 1) * hq // 2] if split \
                else want
            out[f"dh/{hq}x{hkv}/{split}/{rank}"] = np.stack(
                [got.float().numpy(), w.float().numpy()])
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_parts")
    extra = work / "extra.py"
    extra.write_text(EXTRA)
    return serve.run_grid(work, CASES, extra=extra)


@pytest.mark.parametrize("case", CASES, ids="/".join)
def test_tp_serving_matches_jax(case, results):
    """Prefill's last logits, 3 decode steps' logits and the caches,
    gathered, against the JAX package's jitted run under the same
    placements and against the port's unsharded run (the MoE with its
    experts expert-parallel; the encoder-decoder with its cross-attention
    caches)."""
    serve.check_case(case, *results)


def test_seamless_cross_attention_caches_are_split(results):
    """seamless's cross-attention caches came back from every rank in KV
    head blocks (asserted on the ranks with ``local_shape``) and gathered
    to JAX's: their keys are among those compared."""
    _, ranks = results
    keys = [k for k in ranks[2][0] if k.startswith(
        "seamless-m4t-medium/1x2/cache/") and k.endswith(("/xk", "/xv"))]
    assert len(keys) == 2


def test_psum_alone_at_world_two(results):
    """``psum`` gives each rank the sum of both ranks' tensors (a bfloat16
    one summed in float32 and rounded once), and its adjoint is the
    identity: rank r's gradient of the loss sum(c y^2), which both ranks
    compute alike from y = x_0 + x_1, is 2 c y (not twice that)."""
    _, ranks = results
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(2, 3, 4, generator=gen, dtype=torch.float64)
    c = torch.randn(3, 4, generator=gen, dtype=torch.float64)
    y = (xs[0] + xs[1]).numpy()
    bf = (xs[0].to(torch.bfloat16).to(torch.float32)
          + xs[1].to(torch.bfloat16).to(torch.float32)).to(
              torch.bfloat16).to(torch.float64).numpy()
    for r in range(2):
        got = ranks[2][r]
        np.testing.assert_allclose(got[f"psum/y/{r}"], y, rtol=1e-12)
        np.testing.assert_allclose(got[f"psum/grad/{r}"], 2 * c.numpy() * y,
                                   rtol=1e-12)
        np.testing.assert_array_equal(got[f"psum/bf16/{r}"], bf)


@pytest.mark.parametrize("heads", ["4x2", "4x1"])
@pytest.mark.parametrize("split", [True, False], ids=["heads-split",
                                                       "heads-whole"])
def test_dh_sharded_decode_attention(heads, split, results):
    """The head_dim-sharded decode attention, each rank holding half of
    head_dim of every KV head, against ``layers.attention`` on the whole
    tensors: each rank's heads (split) or all heads (whole), to a bf16
    ulp (the scores' partial sums add in another order)."""
    _, ranks = results
    for r in range(2):
        got, want = ranks[2][r][f"dh/{heads}/{split}/{r}"]
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7)


FLASH_OFFSETS = [
    pytest.param(sq, sk, off, causal, window,
                 id=f"sq{sq}-sk{sk}-off{off}-{tag}")
    for sq, sk, off in [(32, 128, 96), (48, 96, 0), (40, 200, 120)]
    for causal, window, tag in [(True, None, "causal"), (True, 50, "win50"),
                                (False, None, "full")]]


@pytest.mark.parametrize("sq,sk,off,causal,window", FLASH_OFFSETS)
def test_flash_offset_plain_matches_jax_attention(sq, sk, off, causal,
                                                  window):
    """``ref.flash_attention(..., q_offset=off)`` (the CPU's flash path)
    against ``repro.models.layers.attention`` with query positions
    ``off + arange(Sq)`` and key positions ``arange(Sk)``, float32, to
    ``FLASH_TOL``; and against the rows ``[off, off + Sq)`` of the
    unshifted run over a query of Sk rows (the block a sequence-parallel
    rank computes)."""
    import jax.numpy as jnp

    import repro.models.layers as jlayers
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    rng = np.random.default_rng(sq + sk + off)
    q_all = rng.normal(size=(2, sk, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
            for _ in range(2))
    q = np.ascontiguousarray(q_all[:, off:off + sq])
    got = kops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window, q_offset=off)
    qpos = jnp.asarray(np.broadcast_to(np.arange(off, off + sq), (2, sq)))
    kpos = jnp.asarray(np.broadcast_to(np.arange(sk), (2, sk)))
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             qpos, kpos, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    whole = ref.flash_attention(*(torch.from_numpy(a) for a in (q_all, k, v)),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), whole[:, off:off + sq].numpy(),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_flash_offset_zero_is_the_unshifted_call(causal, window):
    """``q_offset=0`` leaves the plain version's output as it was, bit for
    bit (bf16 and float32)."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 24, h, 16, generator=gen).to(dtype)
                   for h in (4, 2, 2))
        a = ref.flash_attention(q, k, v, causal=causal, window=window)
        b = ref.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=0)
        assert torch.equal(a, b)
