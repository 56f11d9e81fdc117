"""Prefill + single-token decode with static-shape caches.

The port of ``repro.models.decode``.  Cache sizes are the serving contract:
  attn   -> (cycles, B, max_len, Hkv, Dh)             full causal cache
  swa    -> (cycles, B, min(window, max_len), ...)    ring buffer, O(window)
  rglru  -> (cycles, B, D) fp32 + conv tail (B, W-1, D)     O(1)
  mlstm  -> (cycles, B, H, Dh, Dh) + (.., Dh) fp32          O(1)
  slstm  -> (cycles, B, D) fp32 x3                          O(1)
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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ACT_DTYPE, attention, rmsnorm
from repro_torch.models.model import (
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
    layers_of,
    logits_of,
    shard,
)
from repro_torch.relational.table import resolve_device


def _cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind == "swa":
        return min(cfg.window, max_len)
    return max_len


def _layer_cache(cfg: ArchConfig, kind: str, b: int, max_len: int,
                 src_len: int, device,
                 lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    hkv, dh, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    h = max(cfg.num_heads, 1)

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
        return {"h": zeros(d),
                "conv": zeros(rec.CONV_WIDTH - 1, d, dtype=ACT_DTYPE)}
    if kind == "mlstm":
        return {"c": zeros(h, d // h, d // h), "n": zeros(h, d // h)}
    if kind == "slstm":
        return {"c": zeros(d), "n": zeros(d), "m": zeros(d)}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, src_len: int = 0,
               device=None) -> Dict[str, Any]:
    """Zeroed caches: stacked per cycle slot, one per tail layer; with an
    encoder, ``src_len`` is the encoder's output length."""
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_cycles, tail = divmod(cfg.num_layers, len(pat))
    cyc = {f"s{j}_{kind}": _layer_cache(cfg, kind, batch, max_len, src_len,
                                        device, (n_cycles,))
           for j, kind in enumerate(pat)}
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "cycles": cyc}
    for t in range(tail):
        cache[f"tail_{t}"] = _layer_cache(cfg, pat[t], batch, max_len,
                                          src_len, device)
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


def _attn_step(p: P, cfg: ArchConfig, x, cache_kv, pos, kind: str):
    """x: (B,1,D); cache_kv: {"k","v"}, written in place; returns out."""
    b = x.shape[0]
    posb = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(p, cfg, x, posb)
    ck, cv = cache_kv["k"], cache_kv["v"]
    s_cache = ck.shape[1]
    # an attn cache past its end overwrites its last slot, as the
    # reference's dynamic_update_slice clamps it (on the device, no sync)
    slot = (torch.remainder(pos, s_cache) if kind == "swa"
            else pos.clamp_max(s_cache - 1))
    idx = slot.reshape(1).to(torch.int64)
    ck.index_copy_(1, idx, k)          # in place (JAX: dynamic_update_slice)
    cv.index_copy_(1, idx, v)
    k_pos, valid = _ring_positions(kind, s_cache, pos)
    out = attention(q, ck, cv, posb, k_pos[None].expand(b, s_cache),
                    causal=True, window=cfg.window if kind == "swa" else None,
                    kv_valid=valid[None].expand(b, s_cache))
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"]


def _layer_step(p: P, kind: str, cfg: ArchConfig, x, lc, pos,
                sh: Optional[ActSharding] = None):
    """One block for one token, its cache ``lc`` written in place.
    x: (B,1,D)."""
    h = rmsnorm(x, p["norm1"])
    if kind in ("attn", "swa"):
        mixed = _attn_step(p["attn"], cfg, h, lc, pos, kind)
    elif kind == "rglru":
        out, h_new, conv = rec.rglru_step(p["rglru"], h[:, 0], lc["h"],
                                          lc["conv"])
        lc["h"].copy_(h_new)
        lc["conv"].copy_(conv)
        mixed = out[:, None]
    elif kind == "mlstm":
        out, _ = rec.mlstm_step(p["mlstm"], h[:, 0], (lc["c"], lc["n"]),
                                max(cfg.num_heads, 1))
        mixed = out[:, None]
    elif kind == "slstm":
        out, state = rec.slstm_step(p["slstm"], h[:, 0],
                                    (lc["c"], lc["n"], lc["m"]))
        for key, val in zip("cnm", state):
            lc[key].copy_(val)
        mixed = out[:, None]
    else:
        raise ValueError(kind)
    x = x + mixed
    if "xattn" in p and "xk" in lc:      # cross-attention against encoder
        b, src_len = x.shape[0], lc["xk"].shape[1]
        hx = rmsnorm(x, p["norm_x"])
        q = (hx @ p["xattn"]["wq"]).reshape(b, 1, cfg.num_heads,
                                            cfg.head_dim)
        src_pos = torch.arange(src_len, dtype=torch.int32,
                               device=x.device).expand(b, src_len)
        xo = attention(q, lc["xk"], lc["xv"], pos.reshape(1, 1).expand(b, 1),
                       src_pos, causal=False)
        x = x + xo.reshape(b, 1, cfg.q_dim) @ p["xattn"]["wo"]
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
    batch).
    """
    pos = cache["pos"]
    x = embed_rows(params["embed"], token[:, None]).to(ACT_DTYPE)
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * embed_scale(cfg)
    for p, kind, where in layers_of(params, cfg):
        x = _layer_step(p, kind, cfg, x, _layer_of(cache, where), pos, sh)
    logits = logits_of(params, rmsnorm(x, params["final_norm"]))
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
    ``ActSharding``.
    """
    x, positions = _embed(params, cfg, batch)
    x = shard(x, sh, "hidden")
    b, s, _ = x.shape
    if "rglru" in cfg.block_pattern and s < rec.CONV_WIDTH - 1:
        raise ValueError(
            f"prefill: a {s}-token prompt is shorter than the RG-LRU conv "
            f"state ({rec.CONV_WIDTH - 1} tokens)")
    use_kernel = kops.resolve_use_kernel(use_kernel, x.device)
    enc_out = (_encode(params, cfg, batch["frames"], use_kernel, sh)
               if cfg.encoder is not None else None)
    src_len = enc_out.shape[1] if enc_out is not None else 0
    cache = init_cache(cfg, b, max_len, src_len, device=x.device)
    for p, kind, where in layers_of(params, cfg):
        x, state = _layer_seq(p, kind, cfg, x, positions, use_kernel,
                              enc_out, sh)
        _fill(_layer_of(cache, where), kind, state)
    cache["pos"] = torch.full((), s, dtype=torch.int32, device=x.device)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    x = rmsnorm(x[:, -1:], params["final_norm"])
    return logits_of(params, x)[:, 0, :], cache
