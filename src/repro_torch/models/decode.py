"""Prefill + single-token decode with static-shape caches (attn / swa).

The port of ``repro.models.decode``.  Cache sizes are the serving contract:
  attn   -> (cycles, B, max_len, Hkv, Dh)             full causal cache
  swa    -> (cycles, B, min(window, max_len), ...)    ring buffer, O(window)
Keys are stored *post-RoPE*; ring-buffer positions are reconstructed from
the scalar ``pos`` (a 0-d int32 tensor on the cache's device, so a decode
step needs no host sync).

Where JAX builds a new cache with ``dynamic_update_slice``, the port writes
the new keys and values into the cache's tensors in place (``index_copy_``,
``copy_``), which saves a copy of the whole cache per layer and step: a
cache passed to :func:`decode_step` is consumed, and only the returned one
may be used afterwards.  The recurrent kinds (rglru, mlstm, slstm) and the
encoder's cross-attention cache (``src_len``) are not ported yet
(``model.check_supported``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ACT_DTYPE, attention, rmsnorm
from repro_torch.models.model import (
    ActSharding,
    P,
    _embed,
    _ffn_apply,
    _layer_seq,
    _qkv,
    _take,
    check_supported,
    check_unsharded,
    embed_scale,
    layers_of,
    logits_of,
)
from repro_torch.relational.table import resolve_device


def _cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind == "swa":
        return min(cfg.window, max_len)
    return max_len


def _layer_cache(cfg: ArchConfig, kind: str, b: int, max_len: int,
                 device, lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    s = _cache_len(cfg, kind, max_len)
    shape = lead + (b, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Any]:
    """Zeroed caches: stacked per cycle slot, one per tail layer."""
    check_supported(cfg)
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_cycles, tail = divmod(cfg.num_layers, len(pat))
    cyc = {f"s{j}_{kind}": _layer_cache(cfg, kind, batch, max_len, device,
                                        (n_cycles,))
           for j, kind in enumerate(pat)}
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "cycles": cyc}
    for t in range(tail):
        cache[f"tail_{t}"] = _layer_cache(cfg, pat[t], batch, max_len,
                                          device)
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


def _layer_step(p: P, kind: str, cfg: ArchConfig, x, lc, pos):
    """One block for one token.  x: (B,1,D)."""
    h = rmsnorm(x, p["norm1"])
    x = x + _attn_step(p["attn"], cfg, h, lc, pos, kind)
    ffn = _ffn_apply(p, cfg, x)
    if ffn is not None:
        x = x + ffn
    return x


def decode_step(params: P, cfg: ArchConfig, cache: Dict[str, Any],
                token: torch.Tensor, sh: Optional[ActSharding] = None):
    """One serving step: token (B,) -> (logits (B,V) float32, cache).

    The cache's tensors are updated in place; the returned cache holds them
    with ``pos`` advanced by one.  Past the end of an ``attn`` cache
    (``pos >= max_len``) each step overwrites its last slot, as in the
    reference.
    """
    check_supported(cfg)
    check_unsharded(sh)
    pos = cache["pos"]
    x = params["embed"][token.to(torch.int64)[:, None]].to(ACT_DTYPE)
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * embed_scale(cfg)
    for p, kind, where in layers_of(params, cfg):
        x = _layer_step(p, kind, cfg, x, _layer_of(cache, where), pos)
    logits = logits_of(params, rmsnorm(x, params["final_norm"]))
    return logits[:, 0, :], dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# prefill: full sequence forward that also fills the cache
# ---------------------------------------------------------------------------

def _fill(lc: Dict[str, torch.Tensor], kind: str, k, v) -> None:
    """Write the (roped) prompt keys and values into one layer's cache."""
    s, s_cache = k.shape[1], lc["k"].shape[1]
    if kind == "swa" and s > s_cache:
        # ring layout: the entry at position p lives in slot p % s_cache
        roll = (s - s_cache) % s_cache
        lc["k"].copy_(torch.roll(k[:, -s_cache:], shifts=roll, dims=1))
        lc["v"].copy_(torch.roll(v[:, -s_cache:], shifts=roll, dims=1))
    else:
        lc["k"][:, :s].copy_(k)
        lc["v"][:, :s].copy_(v)


def prefill(params: P, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            max_len: int, sh: Optional[ActSharding] = None,
            use_kernel: Optional[bool] = None):
    """Run the prompt; returns (last-token float32 logits (B,V), cache).

    ``use_kernel=None`` takes the flash kernel for the prompt's
    self-attention on a CUDA device and the plain attention on the CPU.
    """
    check_supported(cfg)
    check_unsharded(sh)
    x, positions = _embed(params, cfg, batch)
    b, s, _ = x.shape
    use_kernel = kops.resolve_use_kernel(use_kernel, x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for p, kind, where in layers_of(params, cfg):
        x, (k, v) = _layer_seq(p, kind, cfg, x, positions, use_kernel)
        _fill(_layer_of(cache, where), kind, k, v)
    cache["pos"] = torch.full((), s, dtype=torch.int32, device=x.device)
    x = rmsnorm(x[:, -1:], params["final_norm"])
    return logits_of(params, x)[:, 0, :], cache
