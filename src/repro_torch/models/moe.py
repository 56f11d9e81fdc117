"""Mixture-of-Experts FFN with sort-based dispatch.

The port of ``repro.models.moe``'s single-device path: flatten the
(token, k) assignments, sort them stably by expert, drop the overflow
beyond each expert's capacity, and scatter into an (experts, capacity,
d_model) buffer; three batched expert products; gather back and sum each
token's gated expert outputs in fp32.  Every shape is static and nothing
syncs with the host.  The expert-parallel ``moe_ffn_shard_map`` (and its
``_local_dispatch``) waits for the sharded slice (ROADMAP.md §1, item 13).

Routing is discontinuous: two runs whose hidden states differ by a bf16
ulp (the flash kernel against the plain attention, or two compilers) pick
other experts for a token whose k-th and (k+1)-th router logits nearly
tie, and its output moves by O(1); and a token that moves into an expert
at capacity drops that expert's last token.  :func:`recording_routes` and
:func:`route_changes` let a comparison of two runs find those tokens.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoESpec
from repro_torch.models.layers import dense_init


def init_moe(gen, d_model: int, spec: MoESpec, device) -> Dict[str,
                                                                torch.Tensor]:
    e, f = spec.num_experts, spec.d_expert
    p = {
        "w_router": dense_init(gen, (d_model, e), dtype=torch.float32,
                               device=device),
        "w_gate": dense_init(gen, (e, d_model, f), device=device),
        "w_up": dense_init(gen, (e, d_model, f), device=device),
        "w_down": dense_init(gen, (e, f, d_model), device=device),
    }
    if spec.shared_expert_dim:
        s = spec.shared_expert_dim
        p["w_shared_gate"] = dense_init(gen, (d_model, s), device=device)
        p["w_shared_up"] = dense_init(gen, (d_model, s), device=device)
        p["w_shared_down"] = dense_init(gen, (s, d_model), device=device)
    return p


def capacity_for(tokens: int, spec: MoESpec) -> int:
    cap = int(math.ceil(spec.capacity_factor * tokens * spec.top_k
                        / spec.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


_RECORDING = threading.local()          # .routes: the open recorder


@contextlib.contextmanager
def recording_routes():
    """Collect, for every :func:`moe_ffn` call this thread makes inside the
    block, in call order, the (T, top_k) experts each token's choices
    reached (-1 where the expert was full and the choice dropped); no host
    sync."""
    outer = getattr(_RECORDING, "routes", None)
    _RECORDING.routes = routes = []
    try:
        yield routes
    finally:
        _RECORDING.routes = outer


def route_changes(a: List[torch.Tensor], b: List[torch.Tensor]
                  ) -> Tuple[List[int], torch.Tensor]:
    """Two runs' recorded routes, call by call: the number of (token, k)
    choices of ``a`` that ``b`` did not make in each call, and the (T,)
    mask of tokens whose choices agreed in every call (as sets: the order
    of a token's k experts does not change its output)."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise ValueError("route_changes: the runs made other calls")
    counts, agree = [], torch.ones(a[0].shape[0], dtype=torch.bool,
                                   device=a[0].device)
    for x, y in zip(a, b):
        missing = ~(x[:, :, None] == y[:, None, :]).any(-1)     # (T, K)
        counts.append(int(missing.sum()))
        agree &= ~missing.any(-1)
    return counts, agree


def route(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """fp32 router: the top-k experts of each token (largest first) and
    their softmax gates.  ``torch.topk`` does not promise ``lax.top_k``'s
    lowest-index order among equal logits; fp32 logits of real inputs do
    not tie.  A token whose hidden state is NaN (an embedding of an id out
    of range) has NaN logits for every expert: ``lax.top_k`` ranks NaN
    above every number, lowest index first, so such a token takes experts
    0..k-1 (and their capacity), as here."""
    logits = x.to(torch.float32) @ w_router                  # (T, E)
    top_vals, top_idx = torch.topk(logits, k, dim=-1)        # (T, K)
    nan_row = torch.isnan(logits).all(-1, keepdim=True)
    top_idx = torch.where(nan_row, torch.arange(k, device=x.device),
                          top_idx)
    return top_idx, torch.softmax(top_vals, dim=-1)


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor],
            spec: MoESpec) -> torch.Tensor:
    """x: (T, D) -> (T, D).  Overflow tokens are dropped (capacity-factor
    semantics): which ones depends on the stable sort, as in JAX."""
    t, d = x.shape
    e, k = spec.num_experts, spec.top_k
    cap = capacity_for(t, spec)
    dev = x.device

    top_idx, gates = route(x, p["w_router"], k)
    e_f = top_idx.reshape(t * k)
    t_f = torch.arange(t, device=dev).repeat_interleave(k)
    g_f = gates.reshape(t * k)

    order = torch.argsort(e_f, stable=True)
    se, st, sg = e_f[order], t_f[order], g_f[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev,
                                                 dtype=se.dtype))
    rank = torch.arange(t * k, device=dev) - starts[se]
    keep = rank < cap
    # dropped assignments land on a scratch row past the buffer
    slot = torch.where(keep, se * cap + rank, e * cap)
    routes = getattr(_RECORDING, "routes", None)
    if routes is not None:
        reached = torch.empty_like(e_f)
        reached[order] = torch.where(keep, se, -1)
        routes.append(reached.reshape(t, k))

    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    xe.index_copy_(0, slot, x[st])
    xe = xe[:-1].reshape(e, cap, d)
    h_gate = torch.bmm(xe, p["w_gate"])
    h_up = torch.bmm(xe, p["w_up"])
    act = F.silu(h_gate.to(torch.float32)) * h_up.to(torch.float32)
    y = torch.bmm(act.to(x.dtype), p["w_down"]).reshape(e * cap, d)

    y_tok = y[torch.clamp(slot, max=e * cap - 1)]
    y_tok = torch.where(keep[:, None], y_tok, 0)
    contrib = y_tok.to(torch.float32) * sg[:, None]
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    out.index_add_(0, st, contrib)

    if spec.shared_expert_dim:
        gate = F.silu((x @ p["w_shared_gate"]).to(torch.float32))
        up = (x @ p["w_shared_up"]).to(torch.float32)
        out = out + ((gate * up).to(x.dtype) @ p["w_shared_down"])
    return out.to(x.dtype)
