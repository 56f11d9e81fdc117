"""Recurrent mixers: RG-LRU (RecurrentGemma) and xLSTM (mLSTM / sLSTM).

The port of ``repro.models.recurrent``, with its dtypes at every cast:
bf16 projections, fp32 gates and states.  The linear RG-LRU recurrence
runs as a log-depth doubling scan over the fp32 ``(a, b)`` pairs (JAX:
``lax.associative_scan``, which combines them in another tree, so the two
agree to fp32 rounding).  The nonlinear LSTM recurrences are Python loops
over time with fp32 state (JAX: ``lax.scan``); everything that does not
depend on the state (projections, gates) is computed for the whole
sequence before the loop, and the loop body is the recurrence alone, in
as few launches as its arithmetic allows.
Every mixer also has a single-step form for decode with an O(1) state.
The mLSTM step updates its ``(C, n)`` state tensors in place (a 16 MB
``(B, H, 512, 512)`` matrix memory a layer at xlstm-1.3b's width), as do
the LSTM sequence loops; when autograd records (training), the sequence
loops take out-of-place forms of the same operations.

Tensor parallelism over ``model``: each mixer takes this rank's blocks of
its weights and states, as ``launch.sharding``'s placements lay them out,
and its place on the ``model`` axis (``tp``, a ``layers.TP``: the process
group, its size and this rank's index; alone by default).  The widths come
from the blocks' shapes, so whole blocks run the single program.  The
sequence and step forms share the exchanges, and no collective runs inside
a time loop:

  * RG-LRU: ``w_x``, ``w_y``, ``conv_w`` and the gates' ``w_rec_gate`` /
    ``w_input_gate`` are column blocks (D / m channels), ``lam`` whole (the
    rank takes its channels of it), ``w_out`` a row block.  ``y``, ``xb``
    and the conv output ``xc`` are the rank's channels; the gates contract
    over the whole D, so ``xc`` is gathered over ``model`` once a layer
    (``all_gather``) and multiplied by the gates' column blocks; ``a``,
    ``b``, the scan and the states ``h`` (B, D/m) and ``conv`` (B, W-1,
    D/m) are the rank's channels; ``w_out`` is closed by ``psum``.
  * sLSTM: ``w_z``, ``w_i``, ``w_f``, ``w_o_gate`` column blocks, ``w_out``
    a row block.  The cell has no recurrence across channels, so every
    gate and the loop over ``c``/``n``/``m`` run on the rank's D / m
    channels; ``w_out`` is closed by ``psum``.
  * mLSTM: the weights are column blocks over D = H Dh (a split by heads,
    ``w_i``/``w_f`` by heads where H divides ``model``, else whole), the
    state ``C[b, h, k, v]`` and ``n[b, h, k]`` are split by the key dim
    ``k`` (Dk = Dh / m).  Rows ``k`` of C evolve alone (``C_t[k] = f_t
    C_{t-1}[k] + i_t k_t[k] v_t``), so a rank runs the whole loop on its
    Dk rows of every head.  Before the loop the stored blocks of ``q`` and
    ``k`` are regrouped to the key split by one ``all_to_all`` each
    (:func:`_to_key_rows`; with H not a multiple of ``model`` a rank's
    columns are part of one head and the exchange is padded); ``v`` and the
    gates are gathered whole.  After the loop the ``q^T [C, n]`` outputs,
    partial sums over ``k``, are summed by one float32 ``psum``, which
    gives the numerators and the ``q . n`` denominators together; the
    output through ``w_o`` (a column block, as the placement lays it out)
    is gathered back into the replicated hidden state.  A decode step
    makes the same exchanges on one position.

The collectives are ``mesh_axes``' differentiable ones, so the same code
serves a tensor-parallel train step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.mesh_axes import all_gather, all_to_all, psum
from repro_torch.models.layers import (TP, block_of, column_input,
                                      dense_init, row_parallel)

CONV_WIDTH = 4
C_RGLRU = 8.0

P = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def init_rglru(gen, d: int, device) -> P:
    p = {name: dense_init(gen, (d, d), device=device)
         for name in ("w_x", "w_y", "w_out")}
    p["conv_w"] = dense_init(gen, (CONV_WIDTH, d), scale=0.5, device=device)
    for name in ("w_input_gate", "w_rec_gate"):
        p[name] = dense_init(gen, (d, d), device=device)
    p["lam"] = uniform_init(gen, (d,), 1.0, 8.0, device)
    return p


def uniform_init(gen, shape, low: float, high: float, device):
    """float32 U[low, high) from ``gen`` (nothing drawn on ``meta``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return (low + (high - low) * u).to(device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_WIDTH.  x: (B,S,D), w: (W,D)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, CONV_WIDTH - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(CONV_WIDTH):
        out = out + xp[:, i: i + s].to(torch.float32) * w[i].to(
            torch.float32)
    return out.to(x.dtype)


def _rglru_coeffs(p: P, xc: torch.Tensor, tp: TP = TP()):
    """Per-step decay a_t and input b_t of h_t = a_t h_{t-1} + b_t, at the
    rank's channels of ``xc``; the gates contract over every channel, so a
    rank's ``xc`` is gathered over ``model`` first."""
    xg = xc
    if xc.shape[-1] < p["w_rec_gate"].shape[0]:
        xg = all_gather(xc, tp.group, xc.dim() - 1)
    rg = torch.sigmoid((xg @ p["w_rec_gate"]).to(torch.float32))
    ig = torch.sigmoid((xg @ p["w_input_gate"]).to(torch.float32))
    lam = block_of(p["lam"], rg.shape[-1], tp)
    log_a = -C_RGLRU * rg * F.softplus(lam)
    a = torch.exp(log_a)
    gated_x = xc.to(torch.float32) * ig
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * gated_x
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: a doubling
    (Hillis-Steele) scan of the pairs under (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2), in ceil(log2 S) steps."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:],
                                                 b[:, :-off])], dim=1)
        if 2 * off < s:        # the last step needs no products of a
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_seq(p: P, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
              tp: TP = TP()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU block.  x: (B,S,D) -> (out, h_last fp32 at the
    rank's channels)."""
    y = F.gelu((x @ p["w_y"]).to(torch.float32), approximate="tanh")
    xb = x @ p["w_x"]
    xc = _causal_conv(xb, p["conv_w"])
    a, b = _rglru_coeffs(p, xc, tp)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    h = linear_scan(a, b)
    out = (h * y).to(x.dtype) @ p["w_out"]
    return row_parallel(out, p["w_out"].shape[0], x.shape[-1], tp), h[:, -1]


def rglru_step(p: P, x: torch.Tensor, h: torch.Tensor,
               conv_state: torch.Tensor, tp: TP = TP()):
    """One decode step.  x: (B,D); h: (B,D) fp32; conv_state: (B,W-1,D)
    (the rank's channels of both).  Returns (out, h_new, new conv_state)."""
    y = F.gelu((x @ p["w_y"]).to(torch.float32), approximate="tanh")
    xb = x @ p["w_x"]
    window = torch.cat([conv_state, xb[:, None, :]], dim=1)     # (B,W,D)
    xc = torch.einsum("bwd,wd->bd", window.to(torch.float32),
                      p["conv_w"].to(torch.float32)).to(x.dtype)
    a, b = _rglru_coeffs(p, xc, tp)
    h_new = a * h + b
    out = (h_new * y).to(x.dtype) @ p["w_out"]
    return row_parallel(out, p["w_out"].shape[0], x.shape[-1], tp), h_new, \
        window[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM, xLSTM)
# ---------------------------------------------------------------------------

def init_mlstm(gen, d: int, num_heads: int, device) -> P:
    p = {name: dense_init(gen, (d, d), device=device)
         for name in ("w_q", "w_k", "w_v", "w_o")}
    for name in ("w_i", "w_f"):
        p[name] = dense_init(gen, (d, num_heads), dtype=torch.float32,
                             device=device)
    return p


def key_block(dh: int, n: int) -> int:
    """Dk, the key rows of each head's memory a rank holds at ``model`` of
    ``n``: ``cache_shardings`` splits the key dim where it divides."""
    return dh // n if dh % n == 0 else dh


def _to_key_rows(u: torch.Tensor, h: int, dh: int, tp: TP) -> torch.Tensor:
    """The rank's key slice of every head (..., H, Dk) from its column
    block ``u`` (..., D/m) of a projection (a split by heads).

    The D columns are H m groups of Dk (group g = h m + j is head h's
    slice j); rank r holds groups [r H, (r + 1) H) and sends group g to
    rank g mod m: one ``all_to_all`` of ceil(H / m) groups to each rank,
    padded where m does not divide H (the pad is never read).  Where the
    key dim does not divide ``model`` the state is whole and ``u`` is
    gathered whole."""
    m, r = tp.n, tp.rank
    lead = u.shape[:-1]
    dk = key_block(dh, m)
    if dk == dh:
        return all_gather(u, tp.group, u.dim() - 1).reshape(*lead, h, dh)
    slots = -(-h // m)
    send = []
    for j in range(m):                 # my groups for rank j, padded
        mine = [g for g in range(h) if (r * h + g) % m == j]
        send += mine + [0] * (slots - len(mine))
    idx = torch.tensor(send, device=u.device)
    out = u.reshape(*lead, h, dk).index_select(-2, idx)
    out = out.reshape(*lead, m, slots, dk).movedim(-3, 0)
    got = all_to_all(out, tp.group).movedim(0, -3)
    got = got.reshape(*lead, m * slots, dk)
    recv = []
    for head in range(h):              # group head m + r came from rank src
        g = head * m + r
        src = g // h
        first = (r - src * h) % m
        recv.append(src * slots + (g - src * h - first) // m)
    return got.index_select(-2, torch.tensor(recv, device=u.device))


def _mlstm_gates(p: P, x: torch.Tensor, h: int, tp: TP = TP()):
    """fp32 q, k / sqrt(Dh) at the rank's key slice of every head (B, [S,]
    H, Dk), v (B, [S,] H, Dh), and the input and forget gates (B, [S,] H).
    x: (B, [S,] D)."""
    lead, d = x.shape[:-1], x.shape[-1]
    dh = d // h
    q, k, v = (x @ p[w] for w in ("w_q", "w_k", "w_v"))
    if v.shape[-1] < d:                 # column blocks: regroup, gather
        q, k = (_to_key_rows(u, h, dh, tp) for u in (q, k))
        v = all_gather(v, tp.group, v.dim() - 1)
    q, k, v = (u.reshape(*lead, h, -1).to(torch.float32) for u in (q, k, v))
    k = k / math.sqrt(dh)
    i = x.to(torch.float32) @ p["w_i"]
    f = x.to(torch.float32) @ p["w_f"]
    if i.shape[-1] < h:                 # the gates' head blocks
        i, f = all_gather(torch.stack([i, f]), tp.group, i.dim()).unbind(0)
    ig = torch.exp(i - F.softplus(i))             # stabilized exp gate
    fg = torch.sigmoid(f)
    return q, k, v, ig, fg


def _summed_over_keys(parts: torch.Tensor, tp: TP) -> torch.Tensor:
    """The ``q^T [C, n]`` partial sums over the rank's key rows summed over
    ``model`` (``psum``).  Every rank then computes its ``w_o`` columns of
    the output from the whole sum, so each one's gradient of it is partial
    too: the sum enters :func:`layers.column_input` (Megatron's pair
    again, this time around the state's split)."""
    return column_input(psum(parts, tp.group), tp)


def _mlstm_out(p: P, num, qn, x, tp: TP = TP()):
    """num / max(|q . n|, 1), heads merged, through w_o: a column block
    whose output is gathered over ``model``."""
    out = num / torch.clamp(torch.abs(qn), min=1.0)[..., None]
    out = out.reshape(*x.shape[:-1], -1).to(x.dtype) @ p["w_o"]
    if out.shape[-1] < x.shape[-1]:
        out = all_gather(out, tp.group, out.dim() - 1, adjoint="slice")
    return out


def _autograd_records(x: torch.Tensor, p: P) -> bool:
    """Whether autograd records this call (a gradient is wanted of ``x``
    or of a parameter): the LSTM loops then take out-of-place forms of
    their in-place serving loops, the same operations in the same order
    (bit-equal results), which autograd can differentiate."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in p.values()))


def mlstm_seq(p: P, x: torch.Tensor, num_heads: int, state0=None,
              tp: TP = TP()):
    """x: (B,S,D) -> (out, (C, n)).  C: (B,H,Dk,Dh), n: (B,H,Dk), fp32, the
    rank's key rows (Dk = Dh whole).

    The memory carries n as one more column: with v' = [v, 1], one update
    C' = f C' + (i k) v'^T is JAX's ``f C + i k v^T`` and ``f n + i k``
    (the products i k and i k 1 are the same), and ``q^T C'`` gives both
    ``q^T C`` and ``q . n``: three launches a step.  The denominators and
    the output projection follow the loop, after the partial sums over a
    split key dim are added over ``model``.
    """
    bsz, s, d = x.shape
    dh = d // num_heads
    q, k, v, ig, fg = _mlstm_gates(p, x, num_heads, tp)
    dk = k.shape[-1]
    mem = torch.zeros((bsz, num_heads, dk, dh + 1), dtype=torch.float32,
                      device=x.device)
    if state0 is not None:
        mem[..., :dh] = state0[0]
        mem[..., dh] = state0[1]

    def time_major(u):
        return u.transpose(0, 1).contiguous()

    qt = time_major(q)[..., None, :]                      # (S,B,H,1,Dh)
    vt = time_major(torch.cat([v, torch.ones_like(v[..., :1])], -1))
    vt = vt[..., None, :]                                 # (S,B,H,1,Dh+1)
    ikt = time_major(ig[..., None] * k)[..., None]        # (S,B,H,Dh,1)
    ft = time_major(fg)[..., None, None]                  # (S,B,H,1,1)
    if _autograd_records(x, p):
        # the same operations out of place, for autograd to record
        steps = []
        for t in range(s):
            mem = torch.addcmul(mem * ft[t], ikt[t], vt[t])
            steps.append(torch.matmul(qt[t], mem))
        outs = torch.stack(steps)
    else:
        outs = torch.empty((s, bsz, num_heads, 1, dh + 1),
                           dtype=torch.float32, device=x.device)
        for t in range(s):
            mem.mul_(ft[t])
            mem.addcmul_(ikt[t], vt[t])
            torch.matmul(qt[t], mem, out=outs[t])
    if dk < dh:                   # partial sums over the key rows
        outs = _summed_over_keys(outs, tp)
    outs = outs[..., 0, :].transpose(0, 1)                # (B,S,H,Dh+1)
    out = _mlstm_out(p, outs[..., :dh], outs[..., dh], x, tp)
    return out, (mem[..., :dh].contiguous(), mem[..., dh].contiguous())


def mlstm_step(p: P, x: torch.Tensor, state, num_heads: int,
               tp: TP = TP()):
    """One decode step.  x: (B,D); state (C, n) (the rank's key rows) is
    updated in place and returned."""
    c, n = state
    q, k, v, ig, fg = _mlstm_gates(p, x, num_heads, tp)
    ig, fg = ig[..., None], fg[..., None]
    c.mul_(fg[..., None]).addcmul_((ig * k)[..., :, None], v[..., None, :])
    n.mul_(fg).addcmul_(ig, k)
    num = torch.matmul(q[..., None, :], c)[..., 0, :]
    qn = (n * q).sum(-1)
    dh = c.shape[-1]
    if k.shape[-1] < dh:          # partial sums over the key rows
        both = _summed_over_keys(torch.cat([num, qn[..., None]], -1), tp)
        num, qn = both[..., :dh], both[..., dh]
    return _mlstm_out(p, num, qn, x, tp), (c, n)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with stabilized exponential gating)
# ---------------------------------------------------------------------------

def init_slstm(gen, d: int, device) -> P:
    p = {"w_z": dense_init(gen, (d, d), device=device)}
    for name in ("w_i", "w_f", "w_o_gate"):
        p[name] = dense_init(gen, (d, d), dtype=torch.float32, device=device)
    p["w_out"] = dense_init(gen, (d, d), device=device)
    return p


def _slstm_inputs(p: P, x: torch.Tensor):
    """z, i, f, o of every step (none depends on the state)."""
    xf = x.to(torch.float32)
    z = torch.tanh((x @ p["w_z"]).to(torch.float32))
    o = torch.sigmoid(xf @ p["w_o_gate"])
    return z, xf @ p["w_i"], xf @ p["w_f"], o


def _slstm_update(zs, i_t, f_t, m, cn, out=None):
    """One step of the stabilized recurrence on ``cn`` = stack(c, n), with
    ``zs`` = stack(z, 1): ``f_s cn + i_s zs`` is JAX's ``f_s c + i_s z``
    and ``f_s n + i_s``.  Returns (cn, m)."""
    fm = f_t + m
    m_new = torch.maximum(fm, i_t)                 # log-space stabilizer
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(fm - m_new)
    return torch.addcmul(f_s * cn, i_s, zs, out=out), m_new


def slstm_seq(p: P, x: torch.Tensor, state0=None, tp: TP = TP()):
    """x: (B,S,D) -> (out, (c, n, m)), fp32 states (B,D) (the rank's
    channels).  Eight launches a step; h = o c / max(n, 1) follows the
    loop."""
    bsz, s, _ = x.shape
    z, i, f, o = _slstm_inputs(p, x)
    d = z.shape[-1]
    if state0 is None:
        zero = torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
        state0 = (zero, zero, zero)
    zs = torch.stack([z, torch.ones_like(z)]).permute(2, 0, 1, 3)
    zs = zs.contiguous()                                  # (S,2,B,D)
    i, f = (u.transpose(0, 1).contiguous() for u in (i, f))
    cn, m = torch.stack(state0[:2]), state0[2]
    if _autograd_records(x, p):
        # the same operations out of place, for autograd to record
        steps = []
        for t in range(s):
            cn, m = _slstm_update(zs[t], i[t], f[t], m, cn)
            steps.append(cn)
        cns = torch.stack(steps)
    else:
        cns = torch.empty((s, 2, bsz, d), dtype=torch.float32,
                          device=x.device)
        for t in range(s):
            cn, m = _slstm_update(zs[t], i[t], f[t], m, cn, out=cns[t])
    c, n = cns[:, 0].transpose(0, 1), cns[:, 1].transpose(0, 1)
    out = (o * c / torch.clamp(n, min=1.0)).to(x.dtype) @ p["w_out"]
    return row_parallel(out, p["w_out"].shape[0], x.shape[-1], tp), \
        (cn[0].clone(), cn[1].clone(), m)


def slstm_step(p: P, x: torch.Tensor, state, tp: TP = TP()):
    z, i, f, o = _slstm_inputs(p, x)
    c, n, m = state
    cn, m = _slstm_update(torch.stack([z, torch.ones_like(z)]), i, f, m,
                          torch.stack([c, n]))
    h = o * cn[0] / torch.clamp(cn[1], min=1.0)
    out = h.to(x.dtype) @ p["w_out"]
    return row_parallel(out, p["w_out"].shape[0], x.shape[-1], tp), \
        (cn[0], cn[1], m)
