"""Training step: microbatch gradient accumulation + remat + chunked xent
(the port of ``repro.training.train_step``).

  * ``remat`` rematerializes each layer cycle in the backward pass
    (``forward(..., remat=True)``: only cycle boundaries persist);
  * microbatches run one after another, their gradients accumulated in
    fp32 buffers, then loss and gradients are divided by their number;
  * the cross-entropy's log-softmax runs in sequence chunks of
    ``XENT_CHUNK`` positions (plus a remainder chunk), as the reference.

Parameters and optimizer state that are ``DTensor``s take the sharded
step (``training.sharded``: FSDP/ZeRO over their placements, and with
``sh.mesh`` the tensor-parallel compute of ``models.model`` over its
``model`` axis, the loss vocab-parallel: :func:`_chunked_xent`); plain
tensors take the step below, on one device, which drops ``sh.mesh``: its
placements are records that change no value.

Attention: the step calls ``forward(..., use_kernel=False)``, the plain
attention, on every device.  The JAX package's ``forward`` never calls its
Pallas flash kernel (its attention is plain ``jnp``), and neither package
has a flash backward: the port's kernel refuses a tensor that requires a
gradient.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.mesh_axes import all_reduce, psum
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import TP
from repro_torch.models.model import (ActSharding, final_hidden,
                                      logits_block, tp_of)
from repro_torch.training.optim import AdamW
from repro_torch.training.sharded import is_sharded, make_sharded_step
from repro_torch.training.tree import leaves, unflatten

XENT_CHUNK = 512
F32 = torch.float32


def _chunk_nll(lg: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk of positions."""
    logp = torch.log_softmax(lg.to(F32), dim=-1)
    return -torch.gather(logp, -1, lb[..., None].to(torch.int64)).sum()


def _chunk_nll_vocab_parallel(lg: torch.Tensor, lb: torch.Tensor, v0: int,
                              group) -> torch.Tensor:
    """:func:`_chunk_nll` of logits whose vocabulary is split over
    ``group``: ``lg`` is this rank's float32 block, columns ``[v0, v0 +
    V_b)``.  The row max over the group (an all-reduce, no gradient through
    it), then one ``psum`` of ``sum exp(l - max)`` beside the label's logit
    (a masked gather: the rank that holds the label gives it, the others
    0), which GSPMD's partition of the reference's log-softmax reduces
    alike.  No rank holds whole logits."""
    mx = all_reduce(lg.detach().amax(-1, keepdim=True), group, op="max")
    local = lb[..., None].to(torch.int64) - v0
    mine = (local >= 0) & (local < lg.shape[-1])
    picked = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1))
    both = psum(torch.cat([torch.exp(lg - mx).sum(-1, keepdim=True),
                           torch.where(mine, picked, 0.0)], -1), group)
    return (mx[..., 0] + torch.log(both[..., 0]) - both[..., 1]).sum()


def chunked_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                tp: TP = TP(), chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (B, S) under float32
    ``logits`` (B, S, V_b), the log-softmax taken chunk by chunk of
    ``chunk`` positions (plus a remainder chunk): :func:`_chunk_nll` of
    whole logits, :func:`_chunk_nll_vocab_parallel` of this rank's block
    of ``vocab`` columns on ``tp``'s ``model`` axis."""
    s_tok = labels.shape[1]
    nll = _chunk_nll
    if logits.shape[-1] < vocab:
        v0 = tp.start(vocab, logits.shape[-1], "logits")
        nll = functools.partial(_chunk_nll_vocab_parallel, v0=v0,
                                group=tp.group)
    n_chunks = max(1, s_tok // chunk)
    c = s_tok // n_chunks
    total = torch.stack([
        nll(logits[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c])
        for i in range(n_chunks)]).sum()
    rem = s_tok - n_chunks * c
    if rem:
        total = total + nll(logits[:, -rem:], labels[:, -rem:])
    return total / (labels.shape[0] * s_tok)


def _chunked_xent(params, cfg: ArchConfig, batch, sh, remat: bool,
                  chunk: int = XENT_CHUNK, gather=None) -> torch.Tensor:
    """Mean next-token loss (``gather``: ``forward``'s, for the sharded
    step).  With ``sh.mesh`` each rank computes its block of the logits
    (``model.logits_block``), vocab-parallel where the head is
    (:func:`chunked_nll`)."""
    x, head = final_hidden(params, cfg, batch, sh=sh, use_kernel=False,
                           remat=remat, gather=gather)
    labels = batch["labels"]
    logits = logits_block(head, x, cfg.vocab_size, sh)
    logits = logits[:, -labels.shape[1]:, :]  # frontends prepend positions
    return chunked_nll(logits, labels, cfg.vocab_size, tp_of(sh), chunk)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    accum_dtype: Any = F32


def make_train_step(cfg: ArchConfig, opt: AdamW,
                    ts: TrainStepConfig = TrainStepConfig(),
                    sh: Optional[ActSharding] = None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).

    ``batch`` holds tensors whose leading dim is the global batch; with
    microbatching the step takes ``microbatches`` equal slices of it in
    turn.  The optimizer writes the new parameters and state into the
    given tensors (see ``optim``); ``metrics["loss"]`` is a 0-d float32
    tensor on the parameters' device (reading it waits for the step).
    ``DTensor`` parameters and state (``sharded.shard_train_state``) take
    the sharded step over their mesh, which gives the same loss and the
    same new parameters and state (``training.sharded``).
    """
    sharded_step = make_sharded_step(cfg, opt, ts, sh)
    one_device = None if sh is None else dataclasses.replace(sh, mesh=None)

    def value_and_grad(params, mb):
        ps = leaves(params)
        diff = [p.detach().requires_grad_(True) for p in ps]
        loss = _chunked_xent(unflatten(params, diff), cfg, mb, one_device,
                             ts.remat)
        grads = torch.autograd.grad(loss, diff)
        return loss.detach(), grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if is_sharded(params):
            return sharded_step(params, opt_state, batch)
        n_mb = ts.microbatches
        if n_mb == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=ts.accum_dtype,
                               device=p.device) for p in leaves(params)]
            loss = torch.zeros((), dtype=F32, device=acc[0].device)
            for i in range(n_mb):
                mb = {k: v[i * (v.shape[0] // n_mb):
                           (i + 1) * (v.shape[0] // n_mb)]
                      for k, v in batch.items()}
                mb_loss, mb_grads = value_and_grad(params, mb)
                for a, g in zip(acc, mb_grads):
                    a.add_(g.to(ts.accum_dtype))
                loss = loss + mb_loss
            grads = [a / n_mb for a in acc]
            loss = loss / n_mb
        new_params, new_state = opt.update(unflatten(params, list(grads)),
                                           opt_state, params)
        return new_params, new_state, {"loss": loss, "step": new_state.step}

    return train_step
