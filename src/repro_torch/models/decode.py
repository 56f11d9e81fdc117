"""Prefill + single-token decode with static-shape caches.

The port of ``repro.models.decode``.  Cache sizes are the serving contract:
  attn   -> (cycles, B, max_len, Hkv, Dh)             full causal cache
  swa    -> (cycles, B, min(window, max_len), ...)    ring buffer, O(window)
  rglru  -> (cycles, B, D) fp32 + conv tail (B, W-1, D)     O(1)
  mlstm  -> (cycles, B, H, Dh, Dh) + (.., Dh) fp32          O(1)
  slstm  -> (cycles, B, D) fp32 x3                          O(1)
(under tensor parallelism D / m channels, and Dh / m key rows of the
mLSTM's memory).
With an encoder, every ``attn`` layer also holds its cross-attention keys
and values ``xk``/``xv`` (B, src_len, Hkv, Dh), and the cache the encoder
output ``enc_out`` (B, src_len, D).  Keys are stored *post-RoPE*;
ring-buffer positions are reconstructed from the scalar ``pos`` (a 0-d
int32 tensor on the cache's device, so a decode step needs no host sync).

Where JAX builds a new cache with ``dynamic_update_slice`` and new state
arrays, the port writes the new keys, values and states into the cache's
tensors in place (``index_copy_``, ``copy_``, the mLSTM's in-place step),
which saves a copy of the whole cache per layer and step: a cache passed
to :func:`decode_step` is consumed, and only the returned one may be used
afterwards.

Tensor parallelism (``ActSharding.mesh``; ``models.model``'s docstring).
The caches are this rank's blocks in ``launch.sharding.cache_shardings``'
layouts.  :func:`prefill` writes ``for_decode=False``'s: the KV heads over
``model`` where they divide, else whole (every rank computes every KV
head).  :func:`decode_step` takes that one or the decode layout, where KV
heads that do not divide shard ``head_dim`` instead (``launch.sharding.
narrow_tree`` narrows one into the other, no communication); it reads the
layout from the cache's shapes.  Attention over a ``head_dim``-sharded
cache (:func:`dh_sharded_attention`) exchanges the query and the output:

  * the scaled query, head-sharded (B, 1, H/m, Dh), is cut into ``m``
    slices of ``head_dim`` and ``all_to_all`` over ``model`` sends slice
    ``j`` to rank ``j``: each rank then holds every head's slice of its own
    ``head_dim`` block (B, 1, H, Dh/m), the cache's block;
  * the scores are partial sums over the slices, all-reduced in float32
    (``psum``) before the masked softmax, which every rank then computes
    alike;
  * each rank's output is every head's slice (B, 1, H, Dh/m); a second
    ``all_to_all`` sends head block ``j`` back to rank ``j``, which
    concatenates the slices into its heads' (B, 1, H/m, Dh) for the
    row-parallel ``wo``.

Per layer and step that moves 2 (B, H, Dh) bf16 tensors and reduces one
(B, H, S) float32 score tensor, where gathering the cache would move
(B, S, Hkv, Dh).  With heads that do not divide ``model`` (the query whole
on every rank) the rank takes its slice of the query and gathers the
output's slices.  The recurrent mixers' states are the rank's blocks in
both layouts (``cache_shardings`` splits them alike for prefill and
decode): the RG-LRU's and sLSTM's channels, the mLSTM's key rows
(``recurrent.py``'s docstring); :func:`prefill` reads their widths from
the mixers' weight blocks.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.mesh_axes import all_gather, all_to_all, psum
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _NEG,
    ACT_DTYPE,
    _attn_mask,
    _rounded,
    attention,
    rmsnorm,
)
from repro_torch.models.model import (
    TP,
    ActSharding,
    P,
    _embed,
    _encode,
    _ffn_apply,
    _layer_seq,
    _qkv,
    _take,
    embed_rows,
    embed_scale,
    kv_for_queries,
    layers_of,
    logits_of,
    out_proj,
    serving_view,
    shard,
    tp_of,
)
from repro_torch.relational.table import resolve_device


def _cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind == "swa":
        return min(cfg.window, max_len)
    return max_len


def _layer_cache(cfg: ArchConfig, kind: str, b: int, max_len: int,
                 src_len: int, device, lead: Tuple[int, ...] = (),
                 kv_heads: Optional[int] = None,
                 state_split: int = 1) -> Dict[str, Any]:
    hkv, dh, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    hkv = hkv if kv_heads is None else kv_heads
    h = max(cfg.num_heads, 1)
    dl = d // state_split

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(lead + (b,) + shape, dtype=dtype, device=device)

    if kind in ("attn", "swa"):
        s = _cache_len(cfg, kind, max_len)
        c = {"k": zeros(s, hkv, dh, dtype=ACT_DTYPE),
             "v": zeros(s, hkv, dh, dtype=ACT_DTYPE)}
        if cfg.encoder is not None and kind == "attn":
            c["xk"] = zeros(src_len, hkv, dh, dtype=ACT_DTYPE)
            c["xv"] = zeros(src_len, hkv, dh, dtype=ACT_DTYPE)
        return c
    if kind == "rglru":
        return {"h": zeros(dl),
                "conv": zeros(rec.CONV_WIDTH - 1, dl, dtype=ACT_DTYPE)}
    if kind == "mlstm":
        dk = rec.key_block(d // h, state_split)
        return {"c": zeros(h, dk, d // h), "n": zeros(h, dk)}
    if kind == "slstm":
        return {"c": zeros(dl), "n": zeros(dl), "m": zeros(dl)}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, src_len: int = 0,
               device=None, kv_heads: Optional[int] = None,
               state_split: int = 1) -> Dict[str, Any]:
    """Zeroed caches: stacked per cycle slot, one per tail layer; with an
    encoder, ``src_len`` is the encoder's output length.  ``kv_heads``:
    the KV heads a rank holds (all by default); ``state_split``: the
    ``model`` ranks the recurrent states are split over (their blocks in
    ``cache_shardings``; 1, whole, by default)."""
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_cycles, tail = divmod(cfg.num_layers, len(pat))
    cyc = {f"s{j}_{kind}": _layer_cache(cfg, kind, batch, max_len, src_len,
                                        device, (n_cycles,), kv_heads,
                                        state_split)
           for j, kind in enumerate(pat)}
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "cycles": cyc}
    for t in range(tail):
        cache[f"tail_{t}"] = _layer_cache(cfg, pat[t], batch, max_len,
                                          src_len, device,
                                          kv_heads=kv_heads,
                                          state_split=state_split)
    if cfg.encoder is not None:
        cache["enc_out"] = torch.zeros((batch, src_len, cfg.d_model),
                                       dtype=ACT_DTYPE, device=device)
    return cache


def _layer_of(cache: Dict[str, Any], where) -> Dict[str, torch.Tensor]:
    """One layer's cache (views into the stacked tensors for a cycle)."""
    if isinstance(where, tuple):
        i, slot = where
        return _take(cache["cycles"][slot], i)
    return cache[where]


# ---------------------------------------------------------------------------
# decode-side attention against the cache
# ---------------------------------------------------------------------------

def _ring_positions(kind: str, s_cache: int, pos: torch.Tensor) -> Tuple:
    slots = torch.arange(s_cache, dtype=torch.int32, device=pos.device)
    if kind == "swa":
        k_pos = pos - torch.remainder(pos - slots, s_cache)
        valid = k_pos >= 0
    else:
        k_pos = slots
        valid = slots <= pos
    return k_pos, valid


def dh_sharded_attention(q, ck, cv, q_pos, k_pos, causal: bool, window,
                         kv_valid, cfg: ArchConfig, tp: TP):
    """:func:`layers.attention` of the query ``q`` (B, Sq, H or H/m, Dh:
    the rank's heads) over a cache block ``ck``/``cv`` (B, Sk, Hkv, Dh/m)
    holding this rank's slice of ``head_dim`` of every KV head (the module
    docstring's exchange).  Returns the rank's heads (B, Sq, H/m or H,
    Dh), in q's dtype."""
    b, sq, hq, dh = q.shape
    dc, n, heads = ck.shape[-1], tp.n, cfg.num_heads
    if dc * n != dh or ck.shape[2] != cfg.num_kv_heads:
        raise ValueError(f"cache block {tuple(ck.shape)} is not a head_dim "
                         f"slice of every KV head over {n} model ranks")
    qs = q * _rounded(1.0 / math.sqrt(dh), q.dtype)   # _scaled, whole Dh
    split = hq < heads
    if split:     # (n, B, Sq, H/m, Dh/m): slice j to rank j
        send = qs.reshape(b, sq, hq, n, dc).permute(3, 0, 1, 2, 4)
        qd = all_to_all(send, tp.group).permute(1, 2, 0, 3, 4).reshape(
            b, sq, heads, dc)
    else:
        qd = qs.narrow(-1, tp.rank * dc, dc)
    hkv = ck.shape[2]
    g = heads // hkv
    logits = torch.einsum("bqhgd,bkhd->bhgqk",
                          qd.reshape(b, sq, hkv, g, dc).to(torch.float32),
                          ck.to(torch.float32))
    logits = psum(logits, tp.group)               # float32 partial sums
    mask = _attn_mask(q_pos, k_pos, causal, window)
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    logits = logits.masked_fill(~mask[:, None, None, :, :], _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(q.dtype).to(torch.float32),
                       cv.to(torch.float32))
    out = out.reshape(b, sq, heads, dc).to(q.dtype)
    if split:     # (n, B, Sq, H/m, Dh/m): head block j back to rank j
        send = out.reshape(b, sq, n, hq, dc).permute(2, 0, 1, 3, 4)
        return all_to_all(send, tp.group).permute(1, 2, 3, 0, 4).reshape(
            b, sq, hq, dh)
    return all_gather(out, tp.group, 3, adjoint="slice")


def _cached_attention(q, ck, cv, q_pos, k_pos, causal: bool, window,
                      kv_valid, cfg: ArchConfig, tp: TP):
    """Attention of the rank's query heads over a cache block: its KV
    heads (whole or split over ``model``) or its ``head_dim`` slice."""
    hq = q.shape[2]
    h0 = tp.start(cfg.num_heads, hq, "query heads")
    if ck.shape[-1] < cfg.head_dim:
        return dh_sharded_attention(q, ck, cv, q_pos, k_pos, causal, window,
                                    kv_valid, cfg, tp)
    k0 = tp.start(cfg.num_kv_heads, ck.shape[2], "KV heads")
    ka, va = kv_for_queries(ck, cv, cfg, h0, hq, k0, contiguous=False)
    return attention(q, ka, va, q_pos, k_pos, causal=causal, window=window,
                     kv_valid=kv_valid)


def _write(c: torch.Tensor, idx, new: torch.Tensor, tp: TP) -> None:
    """Write the new (B, 1, Hkv, Dh) entries at slot ``idx`` of a cache
    block: whole, or this rank's ``head_dim`` slice (in place)."""
    if c.shape[2] != new.shape[2]:
        raise ValueError(f"cache block {tuple(c.shape)} holds other KV heads"
                         f" than this rank's weights give ({new.shape[2]})")
    dc = c.shape[-1]
    if dc < new.shape[-1]:
        new = new.narrow(-1, tp.start(new.shape[-1], dc, "head_dim"), dc)
    c.index_copy_(1, idx, new)     # in place (JAX: dynamic_update_slice)


def _attn_step(p: P, cfg: ArchConfig, x, cache_kv, pos, kind: str,
               tp: TP = TP()):
    """x: (B,1,D); cache_kv: {"k","v"}, written in place; returns out."""
    b = x.shape[0]
    posb = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(p, cfg, x, posb, tp)
    ck, cv = cache_kv["k"], cache_kv["v"]
    s_cache = ck.shape[1]
    # an attn cache past its end overwrites its last slot, as the
    # reference's dynamic_update_slice clamps it (on the device, no sync)
    slot = (torch.remainder(pos, s_cache) if kind == "swa"
            else pos.clamp_max(s_cache - 1))
    idx = slot.reshape(1).to(torch.int64)
    _write(ck, idx, k, tp)
    _write(cv, idx, v, tp)
    k_pos, valid = _ring_positions(kind, s_cache, pos)
    out = _cached_attention(q, ck, cv, posb, k_pos[None].expand(b, s_cache),
                            True, cfg.window if kind == "swa" else None,
                            valid[None].expand(b, s_cache), cfg, tp)
    return out_proj(out, p["wo"], cfg, tp)


def _layer_step(p: P, kind: str, cfg: ArchConfig, x, lc, pos,
                sh: Optional[ActSharding] = None):
    """One block for one token, its cache ``lc`` written in place.
    x: (B,1,D)."""
    tp = tp_of(sh)
    h = rmsnorm(x, p["norm1"])
    if kind in ("attn", "swa"):
        mixed = _attn_step(p["attn"], cfg, h, lc, pos, kind, tp)
    elif kind == "rglru":
        out, h_new, conv = rec.rglru_step(p["rglru"], h[:, 0], lc["h"],
                                          lc["conv"], tp)
        lc["h"].copy_(h_new)
        lc["conv"].copy_(conv)
        mixed = out[:, None]
    elif kind == "mlstm":
        out, _ = rec.mlstm_step(p["mlstm"], h[:, 0], (lc["c"], lc["n"]),
                                max(cfg.num_heads, 1), tp)
        mixed = out[:, None]
    elif kind == "slstm":
        out, state = rec.slstm_step(p["slstm"], h[:, 0],
                                    (lc["c"], lc["n"], lc["m"]), tp)
        for key, val in zip("cnm", state):
            lc[key].copy_(val)
        mixed = out[:, None]
    else:
        raise ValueError(kind)
    x = x + mixed
    if "xattn" in p and "xk" in lc:      # cross-attention against encoder
        b, src_len = x.shape[0], lc["xk"].shape[1]
        hx = rmsnorm(x, p["norm_x"])
        q = (hx @ p["xattn"]["wq"]).reshape(b, 1, -1, cfg.head_dim)
        src_pos = torch.arange(src_len, dtype=torch.int32,
                               device=x.device).expand(b, src_len)
        xo = _cached_attention(q, lc["xk"], lc["xv"],
                               pos.reshape(1, 1).expand(b, 1), src_pos,
                               False, None, None, cfg, tp)
        x = x + out_proj(xo, p["xattn"]["wo"], cfg, tp)
    ffn = _ffn_apply(p, cfg, x, sh)
    if ffn is not None:
        x = x + ffn
    return x


def decode_step(params: P, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor, sh: Optional[ActSharding] = None):
    """One serving step: token (B,) -> (logits (B,V) float32, cache).

    The cache's tensors are updated in place; the returned cache holds them
    with ``pos`` advanced by one (``enc_out`` passed through).  Past the end
    of an ``attn`` cache (``pos >= max_len``) each step overwrites its last
    slot, as in the reference.  ``sh``: see ``ActSharding`` (with
    ``moe_mesh``, ``token`` and the cache are this rank's blocks of the
    batch).  With ``sh.mesh`` the step splits its work over ``model`` (the
    module docstring): ``params`` as ``forward`` takes them, the cache in
    either of ``cache_shardings``' layouts (read from its shapes), the
    logits whole.  A sequence-parallel ``sh`` (``act_sharding`` with
    ``seq``) raises: a step has one position.
    """
    tp = tp_of(sh)
    if tp.seq_par:
        raise ValueError("decode_step: sh shards the sequence; take "
                         "act_sharding(..., seq=None) for decode")
    raw, params, gather = serving_view(params, sh)
    pos = cache["pos"]
    x = embed_rows(params["embed"], token[:, None], cfg.vocab_size,
                   tp).to(ACT_DTYPE)
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * embed_scale(cfg)
    for p, kind, where in layers_of(raw, cfg, gather):
        x = _layer_step(p, kind, cfg, x, _layer_of(cache, where), pos, sh)
    logits = logits_of(params, rmsnorm(x, params["final_norm"]),
                       cfg.vocab_size, sh)
    return logits[:, 0, :], dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# prefill: full sequence forward that also fills the cache
# ---------------------------------------------------------------------------

def _fill(lc: Dict[str, torch.Tensor], kind: str, state) -> None:
    """Write one layer's end-of-prompt state into its cache: the (roped)
    prompt keys and values, or the recurrent states; ``xk``/``xv``."""
    if kind in ("attn", "swa"):
        k, v = state.pop("k"), state.pop("v")
        s, s_cache = k.shape[1], lc["k"].shape[1]
        if kind == "swa" and s > s_cache:
            # ring layout: the entry at position p lives in slot p % s_cache
            roll = (s - s_cache) % s_cache
            lc["k"].copy_(torch.roll(k[:, -s_cache:], shifts=roll, dims=1))
            lc["v"].copy_(torch.roll(v[:, -s_cache:], shifts=roll, dims=1))
        else:
            lc["k"][:, :s].copy_(k)
            lc["v"][:, :s].copy_(v)
    for key, val in state.items():
        lc[key].copy_(val)


def prefill(params: P, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            max_len: int, sh: Optional[ActSharding] = None,
            use_kernel: Optional[bool] = None):
    """Run the prompt; returns (last-token float32 logits (B,V), cache).

    ``use_kernel=None`` takes the flash kernel for every attention over
    the prompt (and the encoder's frames) on a CUDA device and the plain
    attention on the CPU.  A prompt shorter than the RG-LRU's conv tail
    (``CONV_WIDTH - 1`` tokens) raises ``ValueError``: the reference leaves
    that conv cache short, and its next decode step fails.  ``sh``: see
    ``ActSharding``; with ``sh.mesh`` the prompt's work is split over
    ``model`` (``params`` and ``batch`` as ``forward`` takes them) and the
    cache is this rank's block of ``cache_shardings(..., for_decode=False)``
    (under sequence parallelism every rank holds the whole sequence's keys,
    which it gathered).
    """
    tp = tp_of(sh)
    raw, params, gather = serving_view(params, sh)
    x, positions = _embed(params, cfg, batch, tp)
    x = shard(x, sh, "hidden")
    b, s, _ = x.shape
    s = s * tp.n if tp.seq_par else s
    if "rglru" in cfg.block_pattern and s < rec.CONV_WIDTH - 1:
        raise ValueError(
            f"prefill: a {s}-token prompt is shorter than the RG-LRU conv "
            f"state ({rec.CONV_WIDTH - 1} tokens)")
    use_kernel = kops.resolve_use_kernel(use_kernel, x.device)
    enc_out = (_encode(params, cfg, batch["frames"], use_kernel, sh)
               if cfg.encoder is not None else None)
    src_len = enc_out.shape[1] if enc_out is not None else 0
    cache = init_cache(cfg, b, max_len, src_len, device=x.device,
                       kv_heads=_kv_heads(raw, cfg, gather),
                       state_split=_state_split(raw, cfg, gather))
    for p, kind, where in layers_of(raw, cfg, gather):
        x, state = _layer_seq(p, kind, cfg, x, positions, use_kernel,
                              enc_out, sh)
        _fill(_layer_of(cache, where), kind, state)
    cache["pos"] = torch.full((), s, dtype=torch.int32, device=x.device)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    x = x[:, -1:]
    if tp.seq_par:               # the last position is the last rank's
        x = all_gather(x, tp.group, 1, adjoint="slice")[:, -1:]
    x = rmsnorm(x, params["final_norm"])
    return logits_of(params, x, cfg.vocab_size, sh)[:, 0, :], cache


def _first_block(raw: P, cfg: ArchConfig, gather, kinds, mixer: str,
                 name: str) -> Optional[torch.Tensor]:
    """The compute block of weight ``name`` of the first layer whose kind
    is in ``kinds`` (under its ``mixer`` subtree), None without one."""
    for j, kind in enumerate(cfg.block_pattern):
        if kind not in kinds:
            continue
        if raw.get("cycles"):
            key, prefix = f"s{j}_{kind}", ("cycles",)
            sub, cycle = {key: {mixer: {name: raw["cycles"][key][mixer][
                name][0]}}}, 0
        else:
            key, prefix, cycle = f"tail_{j}", (f"tail_{j}",), None
            if key not in raw:
                continue
            sub = {mixer: {name: raw[key][mixer][name]}}
        if gather is not None:
            sub = gather(sub, prefix, cycle)
        return sub[key][mixer][name] if cycle is not None else \
            sub[mixer][name]
    return None


def _kv_heads(raw: P, cfg: ArchConfig, gather) -> Optional[int]:
    """The KV heads a rank's attention layers compute: the head count of
    the first attention layer's ``wk`` block (None without one)."""
    wk = _first_block(raw, cfg, gather, ("attn", "swa"), "attn", "wk")
    return None if wk is None else wk.shape[-1] // cfg.head_dim


RECURRENT_IN = {"rglru": "w_x", "mlstm": "w_q", "slstm": "w_z"}


def _state_split(raw: P, cfg: ArchConfig, gather) -> int:
    """The ``model`` ranks a rank's recurrent mixers split their channels
    over: D over the width of the first recurrent layer's input column
    block (1 without a recurrent layer, or with whole weights)."""
    for kind, name in RECURRENT_IN.items():
        w = _first_block(raw, cfg, gather, (kind,), kind, name)
        if w is not None:
            return cfg.d_model // w.shape[-1]
    return 1
