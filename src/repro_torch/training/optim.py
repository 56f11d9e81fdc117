"""Optimizers: AdamW (fp32 moments over bf16 params) and Adafactor-lite.

The port of ``repro.training.optim``, with its arithmetic: the global-norm
clip over every leaf, ``b ** step`` taken in float32, weight decay where
the (stacked) parameter has ``ndim >= 2`` (so a stacked norm scale is
decayed, as in the reference), and the new parameter cast back to its
dtype.  Leaves are visited in the JAX package's order (sorted keys).

``update`` writes the new parameters and moments into the tensors it was
given and returns them: a full-width model's state is tens of GB, and a
functional update would hold it twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.model import _tensor_from_numpy
from repro_torch.relational.table import resolve_device
from repro_torch.training.tree import flatten_up_to, leaves, tree_map, unflatten

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def state_from_jax(state, device=None) -> AdamWState:
    """The JAX package's optimizer state (an ``AdamWState`` of AdamW or
    AdafactorLite, its leaves as numpy arrays: ``np.asarray`` of each) as
    the port's, with the same tree, dtypes and bits.  ``device=None``
    means the CUDA card."""
    device = resolve_device(device)

    def conv(tree):
        return None if tree is None else tree_map(
            lambda a: _tensor_from_numpy(a, device), tree)
    return AdamWState(step=conv(state.step), m=conv(state.m),
                      v=conv(state.v))


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in float32, as the reference takes it."""
    return 1 - torch.pow(torch.tensor(b, dtype=F32, device=step.device),
                         step.to(F32))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        first = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        gl = leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                               for g in gl))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1c = _bias_correction(self.b1, step)
        b2c = _bias_correction(self.b2, step)
        for g, m, v, p in zip(gl, leaves(state.m), leaves(state.v),
                              leaves(params)):
            g = g.to(F32) * scale
            torch.add(m * self.b1, g * (1 - self.b1), out=m)
            torch.add(v * self.b2, g * (1 - self.b2) * g, out=v)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            del g
            if p.ndim >= 2:  # no decay on norms/biases
                delta = delta + self.weight_decay * p.to(F32)
            p.copy_((p.to(F32) - self.lr * delta).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v)


@dataclasses.dataclass(frozen=True)
class AdafactorLite:
    """Row/column-factored second moments: O(r+c) state per matrix."""

    lr: float = 1e-3
    decay: float = 0.99
    eps: float = 1e-30
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            if p.ndim >= 2:
                return (torch.zeros(p.shape[:-1], dtype=F32,
                                    device=p.device),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                    device=p.device))
            return (torch.zeros(p.shape, dtype=F32, device=p.device),)
        first = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m=unflatten(params, [zeros(p) for p in leaves(params)]),
            v=None,
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        for g, p, fac in zip(leaves(grads), leaves(params),
                             flatten_up_to(params, state.m)):
            g = g.to(F32)
            gg = g * g
            if p.ndim >= 2:
                r, c = fac
                torch.add(self.decay * r, (1 - self.decay) * torch.mean(
                    gg, dim=-1), out=r)
                torch.add(self.decay * c, (1 - self.decay) * torch.mean(
                    gg, dim=-2), out=c)
                denom = torch.sqrt(
                    r[..., :, None] * c[..., None, :]
                    / torch.clamp(torch.mean(r, dim=-1, keepdim=True)
                                  [..., None], min=self.eps))
                upd = g / torch.clamp(denom, min=1e-9)
            else:
                (v,) = fac
                torch.add(self.decay * v, (1 - self.decay) * gg, out=v)
                upd = g / (torch.sqrt(v) + 1e-9)
            p.copy_((p.to(F32) - self.lr * upd).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=None)
