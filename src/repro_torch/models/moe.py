"""Mixture-of-Experts FFN with sort-based dispatch (the port of
``repro.models.moe``).

``moe_ffn``: flatten the (token, k) assignments, sort them stably by
expert, drop the overflow beyond each expert's capacity, and scatter into
an (experts, capacity, d_model) buffer; three batched expert products;
gather back and sum each token's gated expert outputs in fp32, in the
reference's order (deterministic on the card too).  Every shape is static
and nothing syncs with the host.

``moe_ffn_shard_map``: expert parallelism over a ``DeviceMesh``, run once
per rank on its token block and expert blocks: the same routing
(``_local_dispatch``) on the rank's slice of tokens, two
``all_to_all_single``s over ``model`` and tiled ``all_gather``s of the
F-sharded experts over the dp axes, as the reference's ``shard_map``.
``moe_ffn_gathered`` is the reference's other branch (``moe_ffn`` on the
whole batch) for a rank that holds only blocks.  Both are differentiable
with the adjoints of the reference's ``shard_map`` (``mesh_axes``): the
sharded train step's gradients pass through them.

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

from repro_torch.mesh_axes import (all_gather, all_to_all, axes_size,
                                  axis_group, axis_index, sum_gradients)
from repro_torch.models.config import MoESpec
from repro_torch.models.layers import dense_init, place


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
    return _top_k(x.to(torch.float32) @ w_router, k)          # (T, E)


def _top_k(logits: torch.Tensor, k: int):
    top_vals, top_idx = torch.topk(logits, k, dim=-1)        # (T, K)
    nan_row = torch.isnan(logits).all(-1, keepdim=True)
    top_idx = torch.where(nan_row, torch.arange(k, device=logits.device),
                          top_idx)
    return top_idx, torch.softmax(top_vals, dim=-1)


def _local_dispatch(x_me: torch.Tensor, logits: torch.Tensor, spec: MoESpec,
                    cap: int):
    """Top-k routing + capacity packing of one block of tokens (local ops
    only): (sendbuf (E, cap, D), st, slot, keep, gates), where st / slot /
    keep / gates describe each (token, choice) assignment in expert order
    for the combine; a dropped assignment's slot is E * cap.  Records the
    block's routes when :func:`recording_routes` is open."""
    t_me, d = x_me.shape
    e, k = spec.num_experts, spec.top_k
    dev = x_me.device
    top_idx, gates = _top_k(logits, k)
    e_f = top_idx.reshape(t_me * k)
    t_f = torch.arange(t_me, device=dev).repeat_interleave(k)
    g_f = gates.reshape(t_me * k)
    order = torch.argsort(e_f, stable=True)
    se, st, sg = e_f[order], t_f[order], g_f[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev,
                                                 dtype=se.dtype))
    rank = torch.arange(t_me * k, device=dev) - starts[se]
    keep = rank < cap
    # dropped assignments land on a scratch row past the buffer
    slot = torch.where(keep, se * cap + rank, e * cap)
    routes = getattr(_RECORDING, "routes", None)
    if routes is not None:
        reached = torch.empty_like(e_f)
        reached[order] = torch.where(keep, se, -1)
        routes.append(reached.reshape(t_me, k))
    buf = torch.zeros((e * cap + 1, d), dtype=x_me.dtype, device=dev)
    buf.index_copy_(0, slot, x_me[st])
    return buf[:-1].reshape(e, cap, d), st, slot, keep, sg


def _combine(y: torch.Tensor, st, slot, keep, sg, t: int,
             k: int) -> torch.Tensor:
    """(T, D) float32: each token's gated expert outputs summed from 0, in
    expert order, one assignment at a time: the order of the reference's
    ``zeros.at[st].add`` on the host, and deterministic on the card (where
    ``index_add_``'s atomics add in an order that changes from run to
    run).  ``y``: (E * cap, D) expert outputs."""
    by_token = torch.argsort(st, stable=True)  # each token's k, expert order
    slot, keep, sg = slot[by_token], keep[by_token], sg[by_token]
    y_tok = y[torch.clamp(slot, max=y.shape[0] - 1)]
    y_tok = torch.where(keep[:, None], y_tok, 0)
    contrib = (y_tok.to(torch.float32) * sg[:, None]).reshape(t, k, -1)
    out = torch.zeros((t, y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(k):
        out.add_(contrib[:, j])
    return out


def _experts(xe: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The three batched expert products over (E, C, D) tokens."""
    h_gate = torch.bmm(xe, wg)
    h_up = torch.bmm(xe, wu)
    act = F.silu(h_gate.to(torch.float32)) * h_up.to(torch.float32)
    return torch.bmm(act.to(xe.dtype), wd)


def _shared(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The shared expert's output (bf16 in the models)."""
    gate = F.silu((x @ p["w_shared_gate"]).to(torch.float32))
    up = (x @ p["w_shared_up"]).to(torch.float32)
    return (gate * up).to(x.dtype) @ p["w_shared_down"]


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], spec: MoESpec,
            expert_sharding=None) -> torch.Tensor:
    """x: (T, D) -> (T, D).  Overflow tokens are dropped (capacity-factor
    semantics): which ones depends on the stable sort, as in JAX.  The
    shared expert is added in fp32, then the sum cast to ``x.dtype``.
    ``expert_sharding`` (the (E, C, D) buffers' placement) changes no
    value (``layers.place``)."""
    t, d = x.shape
    e, k = spec.num_experts, spec.top_k
    cap = capacity_for(t, spec)
    logits = x.to(torch.float32) @ p["w_router"]
    xe, st, slot, keep, sg = _local_dispatch(x, logits, spec, cap)
    xe = place(xe, expert_sharding, "expert")
    y = place(_experts(xe, p["w_gate"], p["w_up"], p["w_down"]),
              expert_sharding, "expert")
    out = _combine(y.reshape(e * cap, d), st, slot, keep, sg, t, k)
    if spec.shared_expert_dim:
        out = out + _shared(x, p)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# expert parallelism over torch.distributed
# ---------------------------------------------------------------------------

def ep_specs(dp_axes, model_axis: str = "model") -> Dict[str, tuple]:
    """The placements ``moe_ffn_shard_map`` takes its weights in (its
    ``in_specs``): experts over ``model_axis``, the FFN-hidden dim over the
    dp axes, the router whole."""
    dp = tuple(dp_axes)
    return {"w_router": (None, None),
            "w_gate": (model_axis, None, dp), "w_up": (model_axis, None, dp),
            "w_down": (model_axis, dp, None)}


def moe_ffn_shard_map(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      spec: MoESpec, mesh, dp_axes,
                      model_axis: str = "model") -> torch.Tensor:
    """Expert parallelism: this rank's part of the JAX package's
    ``shard_map`` body, step by step, its collectives over
    ``torch.distributed``.

    ``x`` is this rank's (T / ndata, D) token block (the batch over the dp
    axes, replicated over ``model_axis``); ``p`` holds this rank's blocks
    in :func:`ep_specs`' layout: ``w_gate``/``w_up`` (E / nmodel, D, F /
    ndata), ``w_down`` (E / nmodel, F / ndata, D), ``w_router`` (D, E) and
    any shared expert whole.  Returns this rank's (T / ndata, D) block.

      * route this rank's ``t_me = T // (ndata * nmodel)`` tokens (its
        slice of the block by its ``model`` index), at a per-shard
        capacity from ``t_me``;
      * all_to_all over ``model``: each expert's tokens to its rank;
      * the F-sharded expert weights gathered (tiled) over the dp axes, a
        flattened sub-mesh where they are ("pod", "data");
      * the three expert products;
      * all_to_all back, the fp32 combine, cast to ``x.dtype``, and a
        tiled all_gather over ``model`` reassembles the block;
      * the shared expert is added after that cast (JAX's order: ``moe_ffn``
        adds it in fp32 before its cast).  With top-k > 1 the two can
        differ by a rounding; with top-1 the gate is exactly 1, the routed
        sum is one bf16 value, and the two agree bit for bit.

    Gradients, as the transpose of the reference's ``shard_map``: every
    model rank computes the loss from the gathered block, so the closing
    gather's adjoint is this rank's slice; the token block and the router
    enter through :func:`mesh_axes.sum_gradients` over ``model`` (each
    model rank routes other tokens, so their cotangents add); the experts'
    dp gather reduce-scatters its cotangent over the dp axes.
    """
    nmodel = axes_size(mesh, model_axis)
    ndata = axes_size(mesh, tuple(dp_axes))
    t_local, d = x.shape
    if t_local % nmodel:
        raise ValueError(f"moe_ffn_shard_map: {t_local} tokens a rank do "
                         f"not split over {nmodel} {model_axis} ranks")
    t = t_local * ndata
    e, k = spec.num_experts, spec.top_k
    e_local = e // nmodel
    t_me = t // (ndata * nmodel)       # tokens per shard (dp x model)
    cap = max(8, ((int(math.ceil(spec.capacity_factor * t_me * k / e))
                   + 7) // 8) * 8)
    for name, dim in (("w_gate", 0), ("w_up", 0), ("w_down", 0)):
        if p[name].shape[dim] != e_local:
            raise ValueError(f"moe_ffn_shard_map: {name} holds "
                             f"{p[name].shape[dim]} experts, this rank's "
                             f"block is {e_local}")
    model_group = axis_group(mesh, model_axis)
    dp_group = axis_group(mesh, tuple(dp_axes))

    my = axis_index(mesh, model_axis)
    x_me = sum_gradients(x, model_group)[my * t_me:(my + 1) * t_me]
    w_router = sum_gradients(p["w_router"], model_group)
    logits = x_me.to(torch.float32) @ w_router
    sendbuf, st, slot, keep, sg = _local_dispatch(x_me, logits, spec, cap)
    recv = all_to_all(sendbuf.reshape(nmodel, e_local, cap, d), model_group)
    xe = recv.transpose(0, 1).reshape(e_local, nmodel * cap, d)

    # the FSDP'd F shard, gathered once a call
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if dp_group is not None:
        wg = all_gather(wg, dp_group, 2)
        wu = all_gather(wu, dp_group, 2)
        wd = all_gather(wd, dp_group, 1)
    y = _experts(xe, wg, wu, wd)

    y = y.reshape(e_local, nmodel, cap, d).transpose(0, 1)
    back = all_to_all(y, model_group)            # (nmodel, e_l, cap, D)
    out_me = _combine(back.reshape(e * cap, d), st, slot, keep, sg, t_me, k)
    out = all_gather(out_me.to(x.dtype), model_group, 0, adjoint="slice")
    if spec.shared_expert_dim:
        out = out + _shared(x, p)
    return out


def moe_ffn_gathered(x: torch.Tensor, p: Dict[str, torch.Tensor],
                     spec: MoESpec, mesh, dp_axes,
                     model_axis: str = "model") -> torch.Tensor:
    """:func:`moe_ffn` over the whole batch, for a rank holding the blocks
    that ``moe_ffn_shard_map`` takes: the reference's path when the tokens
    do not split over the shards (``moe_ffn`` on the global arrays).  The
    tokens are gathered over the dp axes and the experts over every axis,
    and this rank's block of the output is returned.  Every model rank
    computes the same output, so the experts' gather over ``model`` takes
    its slice of the cotangent; the dp gathers reduce-scatter theirs."""
    dp = tuple(dp_axes)
    dp_group, model_group = axis_group(mesh, dp), axis_group(mesh,
                                                              model_axis)
    whole = dict(p)
    for name, fdim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        w = all_gather(p[name], model_group, 0, adjoint="slice")
        whole[name] = w if dp_group is None else all_gather(w, dp_group,
                                                             fdim)
    xs = x if dp_group is None else all_gather(x, dp_group, 0)
    out = moe_ffn(xs, whole, spec)
    t_local = x.shape[0]
    i = axis_index(mesh, dp) if dp else 0
    return out[i * t_local:(i + 1) * t_local]
