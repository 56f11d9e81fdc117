"""Optimizers: AdamW (fp32 moments over bf16 params) and Adafactor-lite.

The port of ``repro.training.optim``, with its arithmetic: the global-norm
clip over every leaf, ``b ** step`` taken in float32, weight decay where
the (stacked) parameter has ``ndim >= 2`` (so a stacked norm scale is
decayed, as in the reference), and the new parameter cast back to its
dtype.  Leaves are visited in the JAX package's order (sorted keys).

``update`` writes the new parameters and moments into the tensors it was
given and returns them: a full-width model's state is tens of GB, and a
functional update would hold it twice.

Over shards (``DTensor`` gradients, state and parameters: the sharded
train step, ``training.sharded``), each rank updates its blocks with the
same arithmetic:

  * AdamW: the global-norm clip sums each gradient block's squares once
    (a block replicated over an axis counts on the first rank of it:
    ``launch.sharding.owns_block``) and all-reduces the sum over the mesh;
    the update runs on the blocks of the gradients' (ZeRO-3) placement,
    which the moments share; a parameter stored whole over dp (ZeRO-1)
    updates that block of itself and gathers the updated blocks over dp.
  * AdafactorLite keeps its factored state whole on every rank (it is
    O(rows + cols)): each leaf's gradient is gathered whole, one leaf at a
    time, the factors and the update are computed whole, and each rank
    narrows the update to its parameter block.
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


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _sharded(tree) -> bool:
    first = leaves(tree)
    return bool(first) and isinstance(first[0], _dtensor_type())


def _local(t):
    return t.to_local() if isinstance(t, _dtensor_type()) else t


def _next_step(step):
    """``step + 1``, a replicated ``DTensor`` again where ``step`` is one."""
    new = _local(step) + 1
    if isinstance(step, _dtensor_type()):
        return _dtensor_type().from_local(new, step.device_mesh,
                                          step.placements, run_check=False)
    return new


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
        if _sharded(grads):
            return self._update_shards(grads, state, params)
        gl = leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                               for g in gl))
        step = state.step + 1
        coef = self._coefficients(gnorm, step)
        for g, m, v, p in zip(gl, leaves(state.m), leaves(state.v),
                              leaves(params)):
            self._apply(g, m, v, p, *coef)
        return params, AdamWState(step=step, m=state.m, v=state.v)

    def _coefficients(self, gnorm, step):
        """The clip scale and the two bias corrections of a step."""
        return (torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0),
                _bias_correction(self.b1, step),
                _bias_correction(self.b2, step))

    def _apply(self, g, m, v, p, scale, b1c, b2c) -> None:
        """One leaf's (or block's) update, in place."""
        g = g.to(F32) * scale
        torch.add(m * self.b1, g * (1 - self.b1), out=m)
        torch.add(v * self.b2, g * (1 - self.b2) * g, out=v)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
        del g
        if p.ndim >= 2:  # no decay on norms/biases
            delta = delta + self.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - self.lr * delta).to(p.dtype))

    def _update_shards(self, grads, state: AdamWState, params):
        """The update over ``DTensor`` blocks (see the module docstring)."""
        from repro_torch.launch.sharding import (gather_to, narrow_to,
                                                 owns_block, same_layout,
                                                 spec_of)
        from repro_torch.mesh_axes import all_reduce, axis_group

        gl = leaves(grads)
        mesh = gl[0].device_mesh
        specs = [spec_of(g) for g in gl]
        for g, m, v in zip(gl, leaves(state.m), leaves(state.v)):
            if not (same_layout(spec_of(m), spec_of(g))
                    and same_layout(spec_of(v), spec_of(g))):
                raise ValueError("AdamW over shards: the moments' placement "
                                 f"{spec_of(m)} is not the gradients' "
                                 f"{spec_of(g)}")
        owned = [g.to_local() for g, spec in zip(gl, specs)
                 if owns_block(spec, mesh)]
        sq = sum(torch.sum(torch.square(g.to(F32))) for g in owned) \
            if owned else torch.zeros((), dtype=F32,
                                      device=gl[0].to_local().device)
        gnorm = torch.sqrt(all_reduce(
            sq, axis_group(mesh, tuple(mesh.mesh_dim_names))))
        step = _next_step(state.step)
        coef = self._coefficients(gnorm, _local(step))
        for g, spec, m, v, p in zip(gl, specs, leaves(state.m),
                                    leaves(state.v), leaves(params)):
            p_spec, p_loc = spec_of(p), p.to_local()
            block = narrow_to(p_loc, p_spec, spec, mesh)
            self._apply(g.to_local(), m.to_local(), v.to_local(), block,
                        *coef)
            if not same_layout(p_spec, spec):
                p_loc.copy_(gather_to(block, spec, p_spec, mesh))
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
        sharded = _sharded(grads)
        if sharded:
            from repro_torch.launch.sharding import (gather_to, narrow_to,
                                                     spec_of)
        step = _next_step(state.step)
        for g, p, fac in zip(leaves(grads), leaves(params),
                             flatten_up_to(params, state.m)):
            if sharded:       # the whole gradient, one leaf at a time
                spec = spec_of(g)
                g = gather_to(g.to_local(), spec, (None,) * g.ndim,
                              g.device_mesh)
                fac = tuple(_local(f) for f in fac)
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
            if sharded:       # this rank's block of the whole update
                mesh = p.device_mesh
                upd = narrow_to(upd, (None,) * upd.ndim, spec_of(p), mesh)
                p = p.to_local()
            p.copy_((p.to(F32) - self.lr * upd).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=None)
