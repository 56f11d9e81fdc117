"""Shared layer primitives: RMSNorm, RoPE, GQA attention, gated MLPs.

The port of ``repro.models.layers``: pure functions over parameter dicts;
everything takes and returns bf16 activations with fp32 accumulation where
it matters.  Attention supports full-causal, sliding-window, non-causal
(encoder) and cross-attention masks plus single-token decode against a KV
cache.  Where JAX asks a bf16 einsum for an fp32 result
(``preferred_element_type``), the port casts the bf16 operands to fp32
first: the products of bf16 values are exact in fp32, so the two agree up
to the order of the fp32 sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.mesh_axes import psum, sum_gradients

Params = Dict[str, torch.Tensor]

ACT_DTYPE = torch.bfloat16

_NEG = -1e30

_PLACED = threading.local()           # .records: the open recorder


@contextlib.contextmanager
def recording_placements():
    """Collect (field, placement, shape, dtype) of every activation the
    model places (``ActSharding``'s fields) while the block runs, in call
    order: the dry run's accounting."""
    outer = getattr(_PLACED, "records", None)
    _PLACED.records = records = []
    try:
        yield records
    finally:
        _PLACED.records = outer


def place(x: torch.Tensor, spec: Any, field: str) -> torch.Tensor:
    """A sharding constraint's counterpart on one rank: ``x`` unchanged;
    ``spec`` recorded under ``field`` when a recorder is open."""
    records = getattr(_PLACED, "records", None)
    if spec is not None and records is not None:
        records.append((field, spec, tuple(x.shape), x.dtype))
    return x


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the ``model`` axis of ``ActSharding.mesh``:
    its process group (None alone), size and index, and whether the hidden
    states' sequence is split over it."""

    group: Any = None
    n: int = 1
    rank: int = 0
    seq_par: bool = False

    def start(self, whole: int, local: int, what: str) -> int:
        """The first index of this rank's block of ``local`` of ``whole``
        (0 when the block is whole)."""
        if local == whole:
            return 0
        if local * self.n != whole:
            raise ValueError(f"{what}: a block of {local} of {whole} is not "
                             f"one of {self.n} model ranks'")
        return self.rank * local


def block_of(vec: torch.Tensor, n: int, tp: TP) -> torch.Tensor:
    """This rank's ``n`` entries of a vector stored whole (``param_spec``
    keeps 1-D leaves whole: a bias, the RG-LRU's ``lam``) for a
    column-parallel block of ``n`` columns."""
    if vec.shape[-1] == n:
        return vec
    return vec.narrow(-1, tp.start(vec.shape[-1], n, "vector"), n)


def column_input(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The replicated input of a block this rank computes a part of (its
    heads, FFN columns, channels or vocabulary rows): ``x`` itself, its
    gradient summed over ``model`` (``mesh_axes.sum_gradients``, the
    conjugate of :func:`row_parallel`'s ``psum``), since each rank's part
    gives a partial one.  Only where autograd records it: serving pays
    nothing."""
    if tp.n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return sum_gradients(x, tp.group)


def row_parallel(y, rows: int, whole: int, tp: TP):
    """``y``, the product of a weight block of ``rows`` of its ``whole``
    input rows: summed over ``model`` (``psum``) where the block is a
    rank's share of them."""
    if rows == whole:
        return y
    tp.start(whole, rows, "row-parallel block")      # one rank's share
    return psum(y, tp.group)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., S, H, Dh), positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    # float32 log, as JAX takes it (on the host: no copy to the card)
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask: True = attend."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python scalar.  Scalars stay on
    the host: a tensor built there and copied to the card would make every
    call wait for the card."""
    return float(torch.tensor(value, dtype=dtype))


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """``q / sqrt(Dh)`` in q's dtype, the scale rounded to it first."""
    return q * _rounded(1.0 / math.sqrt(q.shape[-1]), q.dtype)


def attention(
    q: torch.Tensor,               # (B, Sq, Hq, Dh)
    k: torch.Tensor,               # (B, Sk, Hkv, Dh)
    v: torch.Tensor,               # (B, Sk, Hkv, Dh)
    q_pos: torch.Tensor,           # (B, Sq)
    k_pos: torch.Tensor,           # (B, Sk)
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,   # (B, Sk) for ragged caches
) -> torch.Tensor:
    """GQA scaled-dot-product attention, fp32 softmax.

    Long sequences route through :func:`chunked_attention` (online softmax)
    so the (Sq, Sk) score matrix never materializes.
    """
    b, sq, hq, dh = q.shape
    if sq > CHUNK_THRESHOLD:   # decode (sq=1) stays dense: (1, Sk) is cheap
        return chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                                 window=window, kv_valid=kv_valid)
    hkv = k.shape[2]
    group = hq // hkv
    qs = _scaled(q).reshape(b, sq, hkv, group, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qs.to(torch.float32),
                          k.to(torch.float32))
    mask = _attn_mask(q_pos, k_pos, causal, window)        # (B, Sq, Sk)
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    logits = logits.masked_fill(~mask[:, None, None, :, :], _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, hq, dh).to(q.dtype)


CHUNK_THRESHOLD = 4096   # chunked (online-softmax) attention above this seq len
Q_CHUNK = 1024
K_CHUNK = 1024


def chunked_attention(
    q: torch.Tensor,               # (B, Sq, Hq, Dh)
    k: torch.Tensor,               # (B, Sk, Hkv, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,           # (B, Sq)
    k_pos: torch.Tensor,           # (B, Sk)
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
    q_chunk: int = Q_CHUNK,
    k_chunk: int = K_CHUNK,
) -> torch.Tensor:
    """Flash-attention-style streaming softmax: O(Cq*Ck) working set.

    The full (Sq, Sk) score matrix never materializes.  Same numerics as
    :func:`attention` up to fp32 accumulation order.  All q-blocks advance
    together through one loop over the kv chunks (``lax.scan`` in JAX).
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nq = -(-sq // q_chunk)
    nk = -(-sk // k_chunk)
    pq, pk = nq * q_chunk - sq, nk * k_chunk - sk
    qf = F.pad(_scaled(q), (0, 0, 0, 0, 0, pq))
    kf = F.pad(k, (0, 0, 0, 0, 0, pk))
    vf = F.pad(v, (0, 0, 0, 0, 0, pk))
    qp = F.pad(q_pos, (0, pq), value=-1)
    kp = F.pad(k_pos, (0, pk), value=2**30)
    kval = kv_valid if kv_valid is not None else torch.ones(
        (b, sk), dtype=torch.bool, device=q.device)
    kval = F.pad(kval, (0, pk), value=False)

    qf = qf.reshape(b, nq, q_chunk, hkv, g, dh).to(torch.float32)
    kf = kf.reshape(b, nk, k_chunk, hkv, dh)
    vf = vf.reshape(b, nk, k_chunk, hkv, dh)
    qp = qp.reshape(b, nq, q_chunk)
    kp = kp.reshape(b, nk, k_chunk)
    kval = kval.reshape(b, nk, k_chunk)

    dev = q.device
    m = torch.full((b, nq, hkv, g, q_chunk), _NEG, device=dev)
    l = torch.zeros((b, nq, hkv, g, q_chunk), device=dev)
    acc = torch.zeros((b, nq, hkv, g, q_chunk, dh), device=dev)
    for c in range(nk):
        kc, vc, kpc, kvc = kf[:, c], vf[:, c], kp[:, c], kval[:, c]
        s = torch.einsum("bnqhgd,bkhd->bnhgqk", qf, kc.to(torch.float32))
        diff = qp[:, :, :, None] - kpc[:, None, None, :]   # (B,N,Cq,Ck)
        mask = torch.ones(diff.shape, dtype=torch.bool, device=dev)
        if causal:
            mask &= diff >= 0
        if window is not None:
            mask &= diff < window
        mask &= kvc[:, None, None, :]
        s = s.masked_fill(~mask[:, :, None, None, :, :], _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnhgqk,bkhd->bnhgqd", p.to(vc.dtype).to(torch.float32),
            vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    outs = torch.einsum("bnhgqd->bnqhgd", out)
    outs = outs.reshape(b, nq * q_chunk, hq, dh)
    return outs[:, :sq].to(q.dtype)


def gated_mlp(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward."""
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if kind == "geglu":
        act = F.gelu(gate.to(torch.float32), approximate="tanh")
    else:
        act = F.silu(gate.to(torch.float32))
    return (act * up.to(torch.float32)).to(x.dtype) @ p["w_down"]


# ---------------------------------------------------------------------------
# parameter initializers
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], shape,
               scale: Optional[float] = None, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """N(0, scale^2) weights (scale ``1/sqrt(shape[0])`` by default), drawn
    in float32 from ``generator`` on its own device, then cast.  On the
    ``meta`` device nothing is drawn or allocated."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=device or w.device, dtype=dtype)
