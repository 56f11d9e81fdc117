"""The composable LM: one builder for all 10 assigned architectures.

The port of ``repro.models.model``.  ``num_layers`` is split into *cycles*
of ``block_pattern`` (plus a tail if not divisible); per-cycle parameters
are stacked along a leading axis, as in JAX, and a Python loop over that
axis takes the place of ``lax.scan``.  The parameter tree has JAX's keys,
dtypes and layouts, so :func:`params_from_jax` carries the JAX package's
parameters across unchanged.  Layer kinds: ``attn`` / ``swa``
(attention), ``rglru``, ``mlstm``, ``slstm`` (``recurrent.py``); the FFN
is a gated MLP or an MoE (``moe.py``); seamless-m4t's encoder
(:func:`_encode`) feeds cross-attention in every decoder layer.

Entry points:
  forward(params, cfg, batch)              full-sequence logits
  prefill(params, cfg, batch, max_len)     (in ``decode``) last logits, cache
  decode_step(params, cfg, cache, token)   (in ``decode``) one token

On a CUDA tensor every attention over a whole sequence (causal and
windowed self-attention, the encoder's, cross-attention) goes through the
hand-written flash kernel (``kernels.ops.flash_attention``); the CPU, and
``use_kernel=False``, take the plain :func:`layers.attention`.

Tensor parallelism over ``model`` (``ActSharding.mesh``, as GSPMD splits
the JAX package's program under ``act_sharding``'s placements).  Each rank
computes with its compute blocks (``launch.sharding.compute_spec``); the
widths it computes at are read from their shapes, so a block that is the
whole tensor (``model`` of 1, or whole weights) runs the single program:

  * attention: ``wq``/``wk``/``wv`` column-parallel by heads (``bq``... cut
    alike), ``wo`` row-parallel closed by :func:`mesh_axes.psum`.  Where the
    KV heads do not divide ``model``, ``wk``/``wv`` stay whole: each rank
    computes every KV head (the cache holds them) and attends with the ones
    its query heads read (``h // group``);
  * the gated MLP: ``w_gate``/``w_up`` column-parallel over F, ``w_down``
    row-parallel closed by ``psum``;
  * the embedding vocab-parallel: each rank looks up the ids in its rows
    (0 elsewhere) and ``psum`` adds them, ``jnp.take``'s semantics kept
    (:func:`embed_rows`); the head vocab-parallel, the logits gathered
    over the vocabulary where an entry point returns them;
  * sequence parallelism (``act_sharding``'s ``seq_par``: the hidden
    states' sequence over ``model``): a rank runs rows ``[r S/m, (r+1)
    S/m)`` with whole weights (but the embedding and head), its keys and
    values gathered over the sequence, its queries at their positions
    (the flash kernel's ``q_offset``);
  * the MoE keeps ``moe_ffn_shard_map``'s expert parallelism (``moe_mesh``);
  * the recurrent mixers (``rglru``, ``mlstm``, ``slstm``) split their
    channels: column blocks in, ``w_out`` row blocks closed by ``psum``
    (the mLSTM's ``w_o`` a column block, gathered), and their states the
    rank's channels (the mLSTM's memory its key rows), as
    ``cache_shardings`` lays them out; ``recurrent.py``'s docstring has
    the exchanges.

The sharded train step (``training.sharded``) runs the same split with
autograd: each column-parallel block's replicated input (the attention's
q/k/v, the gated MLP's gate/up, a recurrent mixer's entry, the head's
input and, under sequence parallelism, the whole looked-up sequence before
a rank takes its rows) enters through :func:`layers.column_input`, whose
gradient is summed over ``model`` (``sum_gradients``, the conjugate of
``psum``'s identity adjoint, as Megatron pairs them); the K/V gathers'
adjoint is a reduce-scatter and the hidden gather before the head takes
its slice.  :func:`final_hidden` hands the train step's vocab-parallel
loss the hidden states: no rank gathers whole logits.  Without a gradient
``column_input`` is the identity, so serving is unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.mesh_axes import (
    all_gather,
    axes_size,
    axis_group,
    axis_index,
    axis_sizes,
    psum,
)
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    ACT_DTYPE,
    TP,
    _rounded,
    attention,
    block_of,
    chunked_attention,
    column_input,
    dense_init,
    gated_mlp,
    place,
    rmsnorm,
    rope,
    row_parallel,
)
from repro_torch.relational.table import resolve_device

P = Dict[str, Any]

@dataclasses.dataclass
class ActSharding:
    """Activation placements of the JAX package (None = unconstrained).

    ``hidden`` (B, S, D), ``heads`` (B, S, H, Dh), ``kv``, ``ffn``,
    ``expert`` (E, C, D) and ``logits`` (B, S, V) are placement tuples
    (``launch.sharding``): in JAX they are ``with_sharding_constraint``s,
    which change no value.  ``mesh`` (a ``DeviceMesh``, set by
    ``act_sharding``) makes the serving entry points (``forward``,
    ``prefill``, ``decode_step``) and the sharded train step split their
    work over its ``model`` axis, as the placements say (the module
    docstring): heads, FFN width and vocabulary by the compute blocks'
    shapes, the sequence where ``hidden`` shards it;
    ``layers.recording_placements`` records each activation's local block
    for the dry run.  ``mesh=None`` leaves the fields records and every
    rank computes whole: the train step on plain tensors (one device)
    drops the mesh.
    ``moe_mesh`` (a ``DeviceMesh``) sends every MoE layer through the
    expert-parallel ``moe_ffn_shard_map`` over its ``model`` axis and
    ``moe_dp_axes``: each rank then runs the model on its block of the
    batch, with its blocks of the experts
    (``launch.sharding.moe_param_specs``).
    """

    mesh: Any = None
    hidden: Any = None
    heads: Any = None
    kv: Any = None
    ffn: Any = None
    expert: Any = None
    logits: Any = None
    moe_mesh: Any = None
    moe_dp_axes: Any = ()


def shard(x: torch.Tensor, sh: Optional[ActSharding], field: str):
    """``with_sharding_constraint``'s counterpart: ``x`` (this rank's
    block: the layers have already split it) unchanged, its placement
    ``getattr(sh, field)`` and its local shape recorded
    (``layers.place``)."""
    return place(x, getattr(sh, field) if sh is not None else None, field)


def tp_of(sh: Optional[ActSharding]) -> TP:
    """:class:`TP` of ``sh`` (alone without ``sh.mesh`` or at ``model`` 1)."""
    mesh = getattr(sh, "mesh", None)
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return TP()
    from repro_torch.launch.sharding import seq_parallel

    return TP(axis_group(mesh, "model"), axis_sizes(mesh)["model"],
              axis_index(mesh, "model"), seq_parallel(sh))


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ArchConfig, device) -> P:
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.q_dim), device=device),
        "wk": dense_init(gen, (cfg.d_model, cfg.kv_dim), device=device),
        "wv": dense_init(gen, (cfg.d_model, cfg.kv_dim), device=device),
        "wo": dense_init(gen, (cfg.q_dim, cfg.d_model), device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=ACT_DTYPE, device=device)
    return p


def _init_ffn(gen, cfg: ArchConfig, device) -> P:
    if cfg.moe is not None:
        return moe.init_moe(gen, cfg.d_model, cfg.moe, device)
    if cfg.mlp == "none" or cfg.d_ff == 0:
        return {}
    return {
        "w_gate": dense_init(gen, (cfg.d_model, cfg.d_ff), device=device),
        "w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), device=device),
        "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), device=device),
    }


def _norm(cfg: ArchConfig, device) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)


def _init_layer(gen, kind: str, cfg: ArchConfig, device) -> P:
    p: P = {"norm1": _norm(cfg, device)}
    if kind in ("attn", "swa"):
        p["attn"] = _init_attn(gen, cfg, device)
    elif kind == "rglru":
        p["rglru"] = rec.init_rglru(gen, cfg.d_model, device)
    elif kind == "mlstm":
        p["mlstm"] = rec.init_mlstm(gen, cfg.d_model,
                                    max(cfg.num_heads, 1), device)
    elif kind == "slstm":
        p["slstm"] = rec.init_slstm(gen, cfg.d_model, device)
    else:
        raise ValueError(kind)
    ffn = _init_ffn(gen, cfg, device)
    if ffn:
        p["norm2"] = _norm(cfg, device)
        p["ffn"] = ffn
    return p


def _init_xlayer(gen, cfg: ArchConfig, device) -> P:
    """Decoder layer with cross-attention (enc-dec archs)."""
    p = _init_layer(gen, "attn", cfg, device)
    p["norm_x"] = _norm(cfg, device)
    p["xattn"] = _init_attn(gen, cfg, device)
    return p


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _take(tree, i: int):
    """Cycle ``i`` of a tree stacked on its leading axis (views)."""
    return _tree_map(lambda x: x[i], tree)


def _stack_into(out, i: int, one) -> None:
    if isinstance(one, dict):
        for k, v in one.items():
            _stack_into(out[k], i, v)
    else:
        out[i].copy_(one)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> P:
    """Random parameters with the JAX package's tree (keys, shapes, dtypes).

    ``device=None`` means the CUDA card (raises without one).  Weights are
    drawn from ``generator`` (on its own device, then moved); the numbers
    differ from ``jax.random``'s, so parity tests carry JAX's parameters
    across with :func:`params_from_jax`.  ``device="meta"`` allocates
    nothing and needs no generator (the counterpart of ``abstract_params``).
    Stacked layers are written one by one into their stacked tensors, so
    the peak is one layer above the parameters.
    """
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        raise ValueError("init_params: a torch.Generator is required")
    pat = cfg.block_pattern
    n_cycles, tail = divmod(cfg.num_layers, len(pat))

    def layer(kind):
        if cfg.encoder is not None and kind == "attn":
            return _init_xlayer(generator, cfg, device)
        return _init_layer(generator, kind, cfg, device)

    cycles = _stacked(n_cycles, lambda: {
        f"s{j}_{kind}": layer(kind) for j, kind in enumerate(pat)})
    params: P = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                            scale=0.02, device=device),
        "final_norm": _norm(cfg, device),
        "cycles": cycles,
    }
    for t in range(tail):
        params[f"tail_{t}"] = _init_layer(generator, pat[t], cfg, device)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    scale=0.02, device=device)
    if cfg.frontend == "patch":
        params["patch_proj"] = dense_init(
            generator, (cfg.d_model, cfg.d_model), device=device)
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": _stacked(cfg.encoder.num_layers, lambda: _init_layer(
                generator, "attn", cfg, device)),
            "final_norm": _norm(cfg, device)}
    return params


def _stacked(n: int, one: Callable[[], P]) -> P:
    """``n`` trees from ``one()`` stacked on a new leading axis, written
    one by one into their stacked tensors (the peak is one tree above
    them); ``{}`` when ``n`` is 0."""
    if not n:
        return {}
    first = one()
    out = _tree_map(lambda x: x.new_empty((n,) + x.shape), first)
    for i in range(n):
        _stack_into(out, i, first if i == 0 else one())
    return out


def abstract_params(cfg: ArchConfig) -> P:
    """The parameter tree on the ``meta`` device: shapes, no allocation."""
    return init_params(cfg, device="meta")


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")            # a writable copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device=None) -> P:
    """The JAX package's parameter tree, as numpy arrays (``np.asarray`` of
    each leaf), as the port's tree: same keys, dtypes and layouts.  bf16
    leaves keep their bits.  ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    return _tree_map(lambda a: _tensor_from_numpy(a, device), tree)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _proj(x, w, b, tp: TP):
    """``x @ w (+ b)``: a column-parallel block when ``w`` is one."""
    y = x @ w
    return y if b is None else y + block_of(b, y.shape[-1], tp)


def _qkv(p: P, cfg: ArchConfig, x, positions, tp: TP = TP()):
    """Projected, biased, roped q (B,S,Hq,Dh) and k, v (B,S,Hkv,Dh), at
    the rank's head counts (the blocks of ``wq``/``wk``/``wv``)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq"), tp).reshape(b, s, -1, dh)
    k = _proj(x, p["wk"], p.get("bk"), tp).reshape(b, s, -1, dh)
    v = _proj(x, p["wv"], p.get("bv"), tp).reshape(b, s, -1, dh)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _cross_kv(p: P, cfg: ArchConfig, src, tp: TP = TP()):
    """Cross-attention keys and values of the encoder output (no bias, no
    RoPE, as in JAX): (B, Sk, Hkv, Dh) each, at the rank's KV heads.  A
    rank that attends with part of the query heads or, under ``seq_par``,
    with its rows reads a part of them: the encoder output enters through
    :func:`layers.column_input`."""
    b, sk, _ = src.shape
    if p["wq"].shape[-1] < cfg.q_dim or tp.seq_par:
        src = column_input(src, tp)
    return ((src @ p["wk"]).reshape(b, sk, -1, cfg.head_dim),
            (src @ p["wv"]).reshape(b, sk, -1, cfg.head_dim))


def kv_for_queries(k, v, cfg: ArchConfig, h0: int, hq: int, k0: int,
                   contiguous: bool = True):
    """The block of KV heads that query heads ``[h0, h0 + hq)`` read (head
    ``h`` reads ``h // group``), of ``k``/``v`` (B, S, H, Dh) holding KV
    heads ``[k0, k0 + H)``: ``k``, ``v`` themselves when they read all,
    else a narrowed block (copied when ``contiguous``: the flash kernel's
    operands).  Each KV head of the block must be read by as many of the
    query heads (``hq`` a multiple of the group or a divisor of it), as on
    every mesh whose ``model`` axis divides the heads by a power of two;
    anything else raises."""
    group = cfg.num_heads // cfg.num_kv_heads
    lo, hi = h0 // group - k0, (h0 + hq - 1) // group + 1 - k0
    if lo < 0 or hi > k.shape[2] or (hq % group and group % hq):
        raise ValueError(f"query heads [{h0}, {h0 + hq}) do not read a "
                         f"block of KV heads [{k0}, {k0 + k.shape[2]}) "
                         f"evenly (group {group})")
    if (lo, hi) == (0, k.shape[2]):
        return k, v
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return (k.contiguous(), v.contiguous()) if contiguous else (k, v)


def out_proj(out, wo, cfg: ArchConfig, tp: TP):
    """(B, S, H, Dh) attention output through ``wo``: a row-parallel block
    (the rank's heads' rows) closed by ``psum`` over ``model``."""
    b, s = out.shape[:2]
    return row_parallel(out.reshape(b, s, -1) @ wo, wo.shape[0], cfg.q_dim,
                        tp)


def _attn_apply(p: P, cfg: ArchConfig, x, positions, kind: str,
                use_kernel: bool = False, causal: bool = True, kv=None,
                sh: Optional[ActSharding] = None, seq_par: bool = False):
    """Full-sequence attention block: self-attention, or cross-attention
    (non-causal, no RoPE) over ``kv = (k, v)`` from :func:`_cross_kv`.
    Returns (out, (k, v)): for self-attention the roped keys and the values
    that ``prefill`` writes into the cache (every KV head the rank
    computed; under ``seq_par`` gathered over the whole sequence).

    Key positions are ``arange``; query positions are ``positions``, which
    are ``arange`` too (``_embed``, ``_encode``) or, under ``seq_par``, the
    rank's block of it from ``q_offset``: exactly the flash kernel's masks.
    """
    tp = tp_of(sh)
    b, s, _ = x.shape
    hq = p["wq"].shape[-1] // cfg.head_dim
    h0 = tp.start(cfg.num_heads, hq, "query heads")
    if hq < cfg.num_heads:
        x = column_input(x, tp)
    q_offset = 0
    if kv is None:
        q, k, v = _qkv(p, cfg, x, positions, tp)
        k_pos = positions
        if seq_par:
            k = all_gather(k, tp.group, 1)
            v = all_gather(v, tp.group, 1)
            q_offset = tp.rank * s
            k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                 device=x.device).expand(b, k.shape[1])
    else:
        q = _proj(x, p["wq"], p.get("bq"), tp).reshape(b, s, hq,
                                                       cfg.head_dim)
        k, v = kv
        causal = False
        k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                             device=x.device).expand(b, k.shape[1])
    k0 = tp.start(cfg.num_kv_heads, k.shape[2], "KV heads")
    ka, va = kv_for_queries(k, v, cfg, h0, hq, k0)
    q = shard(q, sh, "heads")
    window = cfg.window if kind == "swa" else None
    if use_kernel:       # the offset passed only where a rank has one
        offset = {"q_offset": q_offset} if q_offset else {}
        out = kops.flash_attention(q, ka, va, causal=causal, window=window,
                                   **offset)
    elif cfg.force_chunked_attn and s > 1 and kv is None:
        out = chunked_attention(q, ka, va, positions, k_pos, causal=causal,
                                window=window)
    else:
        out = attention(q, ka, va, positions, k_pos, causal=causal,
                        window=window)
    out = shard(out, sh, "heads")
    return out_proj(out, p["wo"], cfg, tp), (k, v)


def _ffn_apply(p: P, cfg: ArchConfig, x, sh: Optional[ActSharding] = None):
    if "ffn" not in p:
        return None
    h = rmsnorm(x, p["norm2"])
    tp = tp_of(sh)
    if cfg.moe is not None:
        rows = h.shape[1]
        if tp.seq_par:      # the MoE takes the tokens whole over model
            h = all_gather(h, tp.group, 1, adjoint="slice")
        lead = h.shape[:-1]
        x2 = h.reshape(-1, h.shape[-1])
        if sh is not None and sh.moe_mesh is not None:
            out = _moe_on_mesh(x2, p["ffn"], cfg, sh)
        else:
            out = moe.moe_ffn(x2, p["ffn"], cfg.moe,
                              expert_sharding=getattr(sh, "expert", None))
        out = out.reshape(*lead, -1)
        return out.narrow(1, tp.rank * rows, rows) if tp.seq_par else out
    if p["ffn"]["w_gate"].shape[-1] < cfg.d_ff:
        h = column_input(h, tp)
    return row_parallel(gated_mlp(h, p["ffn"], cfg.mlp),
                        p["ffn"]["w_down"].shape[0], cfg.d_ff, tp)


def _moe_on_mesh(x2, p: P, cfg: ArchConfig, sh: ActSharding):
    """The reference's rule (``repro/models/model.py:_ffn_apply``): the
    expert-parallel path when the global tokens split evenly over the
    ``model`` x dp shards, else ``moe_ffn`` on the whole batch.  ``x2`` is
    this rank's (T / ndata, D) block."""
    mesh, dp = sh.moe_mesh, tuple(sh.moe_dp_axes)
    ndata = axes_size(mesh, dp)
    shards = axes_size(mesh, "model") * ndata
    t = x2.shape[0] * ndata
    if t % shards == 0 and t // shards >= 1:
        return moe.moe_ffn_shard_map(x2, p, cfg.moe, mesh, dp)
    return moe.moe_ffn_gathered(x2, p, cfg.moe, mesh, dp)


RECURRENT_INPUT = {"rglru": "w_x", "mlstm": "w_q", "slstm": "w_z"}


def _mixer_seq(p: P, kind: str, cfg: ArchConfig, h, positions,
               use_kernel: bool, sh: Optional[ActSharding] = None):
    """A block's mixer over the normed sequence ``h``: (out, the layer's
    cache entries at the end of the sequence).  The RG-LRU's conv state is
    its last W - 1 inputs, ``h[:, -(W-1):] @ w_x`` (None for a shorter
    sequence, whose cache the reference leaves malformed).  The recurrent
    states are the rank's blocks (its channels of ``w_x``)."""
    tp = tp_of(sh)
    if kind in RECURRENT_INPUT and \
            p[kind][RECURRENT_INPUT[kind]].shape[-1] < h.shape[-1]:
        h = column_input(h, tp)          # the rank's channels
    if kind in ("attn", "swa"):
        out, (k, v) = _attn_apply(p["attn"], cfg, h, positions, kind,
                                  use_kernel, sh=sh, seq_par=tp.seq_par)
        return out, {"k": k, "v": v}
    if kind == "rglru":
        out, h_last = rec.rglru_seq(p["rglru"], h, tp=tp)
        w = rec.CONV_WIDTH - 1
        conv = h[:, -w:] @ p["rglru"]["w_x"] if h.shape[1] >= w else None
        return out, {"h": h_last, "conv": conv}
    if kind == "mlstm":
        out, (c, n) = rec.mlstm_seq(p["mlstm"], h, max(cfg.num_heads, 1),
                                    tp=tp)
        return out, {"c": c, "n": n}
    if kind == "slstm":
        out, (c, n, m) = rec.slstm_seq(p["slstm"], h, tp=tp)
        return out, {"c": c, "n": n, "m": m}
    raise ValueError(kind)


def _layer_seq(p: P, kind: str, cfg: ArchConfig, x, positions,
               use_kernel: bool = False, enc_out=None,
               sh: Optional[ActSharding] = None):
    """One block, full sequence.  Returns (x, the layer's cache entries:
    see :func:`_mixer_seq`, plus ``xk``/``xv`` with cross-attention)."""
    h = rmsnorm(x, p["norm1"])
    mixed, state = _mixer_seq(p, kind, cfg, h, positions, use_kernel, sh)
    x = x + mixed
    if "xattn" in p:                 # cross-attention (decoder of enc-dec)
        xk, xv = _cross_kv(p["xattn"], cfg, enc_out, tp_of(sh))
        hx = rmsnorm(x, p["norm_x"])
        out, _ = _attn_apply(p["xattn"], cfg, hx, positions, "attn",
                             use_kernel, kv=(xk, xv), sh=sh)
        x = x + out
        state.update(xk=xk, xv=xv)
    ffn = _ffn_apply(p, cfg, x, sh)
    if ffn is not None:
        x = shard(x + ffn, sh, "hidden")
    return x, state


def embed_rows(embed: torch.Tensor, tokens: torch.Tensor,
               vocab: Optional[int] = None, tp: TP = TP()) -> torch.Tensor:
    """The embedding rows of ``tokens``, as ``jnp.take(embed, tokens,
    axis=0)`` gives them: an id in ``[-V, 0)`` counts from the end, and an
    id outside ``[-V, V)`` gives a row of NaN (``take``'s fill mode), where
    plain indexing would raise (a device assert on the card).  No host
    sync.

    ``embed`` may be this rank's block of ``vocab`` rows (vocab-parallel):
    each rank takes the rows it holds, 0 for the others, and ``psum`` over
    ``model`` adds the one row each id has (in float32: exact)."""
    v = embed.shape[0]
    vocab = v if vocab is None else vocab
    ids = tokens.to(torch.int64)
    if v == vocab:
        rows = embed[torch.remainder(ids, v)]
    else:
        local = torch.remainder(ids, vocab) - tp.start(vocab, v, "embed")
        mine = (local >= 0) & (local < v)
        rows = embed[local.clamp(0, v - 1)].to(torch.float32)
        rows = psum(torch.where(mine[..., None], rows, 0.0),
                    tp.group).to(embed.dtype)
    inside = (ids >= -vocab) & (ids < vocab)
    return torch.where(inside[..., None], rows, float("nan"))


def _embed(params: P, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
           tp: TP = TP()):
    """Token (+ patch frontend) embedding -> (x, positions); under
    sequence parallelism this rank's block of the sequence."""
    x = embed_rows(params["embed"], batch["tokens"], cfg.vocab_size,
                   tp).to(ACT_DTYPE)
    if cfg.family in ("dense", "moe", "vlm", "hybrid", "ssm") and \
            cfg.frontend == "patch" and "embeds" in batch:
        pe = batch["embeds"].to(ACT_DTYPE) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    if cfg.family in ("dense", "hybrid") and cfg.name.startswith(
            ("gemma", "recurrentgemma")):
        x = x * embed_scale(cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if tp.seq_par:
        if s % tp.n:
            raise ValueError(f"sequence parallelism: {s} positions do not "
                             f"split over {tp.n} model ranks")
        rows = s // tp.n
        # each rank's rows take their part of the gradient of the whole
        # lookup, which every rank's embedding block needs
        x = column_input(x, tp).narrow(1, tp.rank * rows, rows)
        positions = positions.narrow(1, tp.rank * rows, rows)
    return x, positions


def embed_scale(cfg: ArchConfig) -> float:
    """gemma's ``sqrt(d_model)``, taken in float32 and rounded to bf16."""
    return _rounded(_rounded(math.sqrt(cfg.d_model), torch.float32),
                    ACT_DTYPE)


def logits_block(params: P, x, vocab: int,
                 sh: Optional[ActSharding] = None) -> torch.Tensor:
    """float32 logits of the final hidden states (tied or own head), at
    this rank's block of the vocabulary where the head is a block of
    ``vocab`` columns (its replicated input then enters through
    :func:`layers.column_input`); recorded under ``sh.logits``."""
    head = params.get("head")
    cols = params["embed"].shape[0] if head is None else head.shape[-1]
    if cols < vocab:
        x = column_input(x, tp_of(sh))
    logits = x @ params["embed"].T if head is None else x @ head
    return shard(logits.to(torch.float32), sh, "logits")


def logits_of(params: P, x, vocab: Optional[int] = None,
              sh: Optional[ActSharding] = None) -> torch.Tensor:
    """float32 logits of the final hidden states (tied or own head): a
    vocab-parallel head's (:func:`logits_block`) gathered over ``model``."""
    logits = logits_block(params, x, vocab or 0, sh)
    if vocab is not None and logits.shape[-1] < vocab:
        logits = all_gather(logits, tp_of(sh).group, logits.dim() - 1,
                            adjoint="slice")
    return logits


def _unstacked(tree) -> list:
    """The per-cycle trees of a tree stacked on its leading axis, as views
    (``unbind``: under autograd one ``stack`` gathers the stacked
    gradient, where indexing each cycle would add a zero-filled gradient
    of the whole stack for every cycle)."""
    if not tree:
        return []
    unbound = _tree_map(lambda x: x.unbind(0), tree)
    n = len(next(iter(_leaves(unbound))))
    return [_tree_map(lambda u: u[i], unbound) for i in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def layers_of(params: P, cfg: ArchConfig, gather: Optional[Callable] = None):
    """(parameters, kind, cycle index or tail name) of every layer, in
    order; cycle parameters are views into the stacked tensors, or each
    cycle's subtree through ``gather`` (``forward``'s hook) at the start
    of the cycle, and each tail layer through it."""
    pat = cfg.block_pattern
    for i, cp in enumerate(_unstacked(params["cycles"])):
        if gather is not None:
            cp = gather(cp, ("cycles",), i)
        for j, kind in enumerate(pat):
            yield cp[f"s{j}_{kind}"], kind, (i, f"s{j}_{kind}")
    t = 0
    while f"tail_{t}" in params:
        tl = params[f"tail_{t}"]
        yield (tl if gather is None else gather(tl, (f"tail_{t}",), None),
               pat[t], f"tail_{t}")
        t += 1


def _encode(params: P, cfg: ArchConfig, frames: torch.Tensor,
            use_kernel: bool = False,
            sh: Optional[ActSharding] = None) -> torch.Tensor:
    """Encoder stack over precomputed frame embeddings (B, S_src, D): the
    audio frontend is a stub, as in JAX.  Non-causal self-attention."""
    x = frames.to(ACT_DTYPE)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    enc = params["encoder"]
    for lp in _unstacked(enc["layers"]):
        h = rmsnorm(x, lp["norm1"])
        out, _ = _attn_apply(lp["attn"], cfg, h, positions, "attn",
                             use_kernel, causal=False, sh=sh)
        x = x + out
        ffn = _ffn_apply(lp, cfg, x, sh)
        if ffn is not None:
            x = x + ffn
    return rmsnorm(x, enc["final_norm"])


class _Gathered:
    """The top-level subtrees of ``params`` (all but ``cycles``), each
    turned whole by ``gather(subtree, (key,), None)`` at its first use in
    one forward and reused after (a tied embedding is gathered once, for
    the lookup and the head)."""

    def __init__(self, params: P, gather: Callable):
        self._params, self._gather, self._done = params, gather, {}

    def __getitem__(self, key):
        if key not in self._done:
            self._done[key] = self._gather(self._params[key], (key,), None)
        return self._done[key]

    def __contains__(self, key) -> bool:
        return key in self._params

    def get(self, key, default=None):
        return self[key] if key in self._params else default


def serving_view(params: P, sh: Optional[ActSharding],
                 gather: Optional[Callable] = None):
    """(blocks, params, gather) an entry point runs on: a tree of
    ``DTensor``s becomes its local blocks and ``launch.sharding.
    serving_gather``'s hook (its compute blocks, gathered per cycle);
    ``params`` reads the top-level subtrees through ``gather`` when there
    is one.  Plain tensors are the compute blocks themselves."""
    if gather is None and params:
        first = next(_leaves(params))
        if type(first).__name__ == "DTensor":
            from repro_torch.launch.sharding import serving_gather

            params, gather = serving_gather(params, sh)
    return params, (params if gather is None else _Gathered(params, gather)), \
        gather


def forward(params: P, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            sh: Optional[ActSharding] = None,
            use_kernel: Optional[bool] = None,
            remat: bool = False,
            gather: Optional[Callable] = None) -> torch.Tensor:
    """Full-sequence float32 logits (B, S, V): :func:`logits_of` of
    :func:`final_hidden`.

    ``batch``: ``tokens`` (B, S) int, plus ``embeds`` (patch frontend) or
    ``frames`` (B, S_src, D) (the encoder's input).  ``use_kernel=None``
    takes the flash kernel on a CUDA device and the plain attention on the
    CPU (``kernels.ops.resolve_use_kernel``).

    ``remat`` (training): each cycle of ``block_pattern`` is
    rematerialized in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), which keeps only its input, as the reference's
    ``jax.checkpoint`` with ``nothing_saveable``; tail layers are not.

    ``sh``: see :class:`ActSharding`; with ``moe_mesh`` the batch and the
    MoE parameters are this rank's blocks.  With ``sh.mesh`` the rank
    computes on its ``model`` blocks (the module docstring) and the logits
    come back whole; ``params`` is then a tree of ``DTensor``s placed by
    ``launch.sharding.params_shardings`` (or any placement: each leaf is
    gathered to its ``compute_spec`` block, over dp once a cycle), or of
    plain compute blocks, and ``batch`` is this rank's block of the batch
    (``batch_shardings``).

    ``gather`` (the sharded train step, ``training.sharded``): ``params``
    holds this rank's stored blocks, and ``gather(subtree, path, cycle)``
    returns the tensors the layers compute with.  Each cycle's subtree
    (views of cycle ``cycle`` of the stacked blocks under ``("cycles",)``)
    is gathered at the start of the cycle, inside the rematerialized
    function: under ``remat`` it is gathered again in the recompute and
    freed after the cycle (FSDP).  Every other top-level subtree (the
    embedding, the head, the final norm, tail layers, the encoder) is
    gathered where it is first used (``cycle`` None).
    """
    x, params = final_hidden(params, cfg, batch, sh, use_kernel, remat,
                             gather)
    return logits_of(params, x, cfg.vocab_size, sh)


def final_hidden(params: P, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 sh: Optional[ActSharding] = None,
                 use_kernel: Optional[bool] = None,
                 remat: bool = False, gather: Optional[Callable] = None):
    """:func:`forward`'s body: (the final normed hidden states (B, S, D),
    whole over the sequence, the parameters the head reads them with,
    through ``gather`` where there is one).  The train step's
    vocab-parallel loss takes them here, at its block of the logits."""
    raw, params, gather = serving_view(params, sh, gather)
    tp = tp_of(sh)
    x, positions = _embed(params, cfg, batch, tp)
    x = shard(x, sh, "hidden")
    use_kernel = kops.resolve_use_kernel(use_kernel, x.device)
    enc_out = (_encode(params, cfg, batch["frames"], use_kernel, sh)
               if cfg.encoder is not None else None)
    pat = cfg.block_pattern

    def cycle(x, cp, i):
        if gather is not None:
            cp = gather(cp, ("cycles",), i)
        for j, kind in enumerate(pat):
            x, _ = _layer_seq(cp[f"s{j}_{kind}"], kind, cfg, x, positions,
                              use_kernel, enc_out, sh)
        return x

    for i, cp in enumerate(_unstacked(raw["cycles"])):
        if remat:
            x = torch.utils.checkpoint.checkpoint(cycle, x, cp, i,
                                                  use_reentrant=False)
        else:
            x = cycle(x, cp, i)
    t = 0
    while f"tail_{t}" in params:
        x, _ = _layer_seq(params[f"tail_{t}"], pat[t], cfg, x, positions,
                          use_kernel, enc_out, sh)
        t += 1
    x = rmsnorm(x, params["final_norm"])
    if tp.seq_par:
        x = all_gather(x, tp.group, 1, adjoint="slice")
    return x, params
