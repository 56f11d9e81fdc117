"""The sharded train step: FSDP/ZeRO over ``DTensor`` placements (the port
of ``jax.jit(make_train_step(..., sh=act_sharding(...)))`` over
parameters placed by ``params_shardings`` and AdamW moments under the
ZeRO-3 placements, ``repro/launch/dryrun.py``).

State.  Every parameter and optimizer leaf is a
``torch.distributed.tensor.DTensor`` on one ``DeviceMesh``: its local block
is exactly ``launch.sharding.local_shape(shape, spec)`` of its placement.
Parameters take ``params_shardings`` (ZeRO-1 or ZeRO-3 by
``zero_policy``), AdamW's ``m`` and ``v`` the ZeRO-3 placements, ``step``
is replicated (:func:`shard_train_state`, :func:`init_state`).  The step
reads every placement from the leaves; a checkpoint reads whole leaves
(``full_tensor``).  No model operation runs on a ``DTensor``: the layers
compute on local tensors, through the port's own collectives.

One step, on every rank of the mesh at once:

  * the batch: each leaf whole on every rank (a ``DTensor`` batch is
    gathered first: token ids are small).  Microbatch ``i`` is rows
    ``[i mb, (i + 1) mb)`` of the global batch, as the reference slices
    it, and this rank runs its block of those rows over the dp axes
    (``batch_shardings``: rows that do not split over dp run whole on
    every dp rank).  For the MoE the grouping matters: capacity and
    dropped tokens depend on which tokens share a microbatch;
  * FSDP (``forward(..., gather=)``): each layer cycle's parameters are
    gathered from their stored blocks at the start of the cycle, inside
    the function ``torch.utils.checkpoint`` rematerializes, so under
    ``remat`` they are gathered again in the recompute and freed after the
    cycle ("twice per microbatch", as the dry run reckons); the embedding,
    head, final norm and any tail layer are gathered where they are first
    used.  Each leaf is gathered to its compute block
    (``launch.sharding.compute_spec``, as the serving entry points take
    it): over the dp axes, keeping its ``model`` block where the layers
    split the work over ``model``;
  * tensor-parallel compute over ``model`` (``sh.mesh``, as GSPMD splits
    the JAX package's jitted step under ``act_sharding``): each rank runs
    its heads, FFN columns, recurrent channels and vocabulary block, the
    row-parallel blocks closed by ``psum`` and every column-parallel
    block's replicated input entered through ``sum_gradients``
    (``models.model``'s docstring); under ``seq_par`` its rows of the
    sequence with whole weights.  The loss is vocab-parallel
    (``train_step._chunked_xent``): no rank holds whole logits.  The
    experts take ``moe_ffn_shard_map``'s layout (experts over ``model``,
    the FFN-hidden dim over dp) when ``sh.moe_mesh`` is set;
  * the loss: each rank's mean over its rows, scaled by its rows over the
    microbatch's rows (1 / ndp where the rows do not split) before the
    backward, so that the reductions sum to the global mean's gradient;
    the reported loss is that sum over dp, averaged over microbatches;
  * gradients: the backward of each gather reduces the compute block's
    gradient onto the block of the ZeRO-3 placement in ``ts.accum_dtype``
    (float32), once per microbatch and cycle (:meth:`LeafPlan.to_grad`):
    a reduce-scatter over the axes over which it is a partial sum
    (:func:`leaf_plans`) along the dimension ZeRO-3 shards over them (an
    all-reduce where none does), and a slice along any other.  The
    experts' gradients arrive already summed over dp (the MoE's gather of
    the F shard reduce-scatters its cotangent) and in the ZeRO-3 layout;
  * the update: the optimizer over the shards (``optim``): AdamW on the
    ZeRO-3 blocks in place, the global norm over distinct elements, and
    under ZeRO-1 the updated blocks gathered over dp once a step.

At ``model`` 1 the compute blocks are whole over ``model`` and each rank
runs the single program on its rows: the tensor-parallel operators are the
identity there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import axes_size, axis_group, axis_index, \
    axis_sizes, dp_axes
from repro_torch.launch.sharding import (
    _entry_axes,
    _map_with_path,
    compute_spec,
    distribute,
    is_expert,
    local_shape,
    params_shardings,
    placements,
    same_layout,
    seq_parallel,
    spec_of,
    to_compute,
)
from repro_torch.mesh_axes import all_reduce, reduce_scatter
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import ActSharding
from repro_torch.training.tree import flatten, leaves, tree_map, unflatten

F32 = torch.float32
# the blocks a rank computes a part of when their weights split over model
SPLIT_BLOCKS = ("attn", "xattn", "rglru", "mlstm", "slstm")


def is_sharded(tree) -> bool:
    """Whether the leaves of ``tree`` are ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    first = leaves(tree)
    return bool(first) and isinstance(first[0], DTensor)


def local_tree(tree):
    """The local blocks of a tree of ``DTensor``s (views)."""
    return tree_map(lambda t: t.to_local(), tree)


def whole_tree(tree):
    """Every leaf whole on every rank (``full_tensor``: a collective)."""
    return tree_map(lambda t: t.full_tensor(), tree)


def state_specs(params, mesh, cfg: Optional[ArchConfig], state):
    """The placements of an optimizer state for ``params`` (a tree of
    tensors or ``DTensor``s with the global shapes): AdamW's ``m`` and
    ``v`` under ZeRO-3, ``step`` and AdafactorLite's factors replicated."""
    z3 = params_shardings(params, mesh, cfg, policy="zero3")
    if state.v is not None:
        return type(state)(step=(), m=z3, v=z3)
    return type(state)(step=(), m=tree_map(lambda t: (None,) * t.dim(),
                                           state.m), v=None)


def shard_train_state(params, state, cfg: Optional[ArchConfig], mesh,
                      policy: Optional[str] = None):
    """Whole parameters and optimizer state (the same on every rank: for
    example ``params_from_jax`` and ``optim.state_from_jax``, or
    ``init_params`` from one seed) as ``DTensor`` trees on ``mesh``:
    parameters under ``params_shardings(..., policy)`` (ZeRO-1 or ZeRO-3
    by ``zero_policy`` when None), the state under :func:`state_specs`.
    Where a block is the whole tensor (a 1x1 mesh) it is the same memory,
    which the step then updates in place."""
    p_specs = params_shardings(params, mesh, cfg, policy)
    return (distribute(params, p_specs, mesh),
            distribute(state, state_specs(params, mesh, cfg, state), mesh))


def init_state(opt, params, cfg: Optional[ArchConfig]):
    """``opt.init`` for ``DTensor`` parameters, built shard by shard (no
    whole moment is ever allocated): AdamW's moments as zeros of their
    ZeRO-3 blocks, AdafactorLite's factors whole on every rank, ``step``
    replicated."""
    from torch.distributed.tensor import DTensor

    first = leaves(params)[0]
    mesh = first.device_mesh
    dev = first.to_local().device
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    like = opt.init(meta)
    specs = state_specs(meta, mesh, cfg, like)

    def zeros(t, spec):
        block = torch.zeros(local_shape(tuple(t.shape), spec, mesh),
                            dtype=t.dtype, device=dev)
        return DTensor.from_local(block, mesh, placements(spec, mesh),
                                  run_check=False)

    def build(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k], s[k]) for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f), getattr(s, f))
                             for f in t._fields))
        if isinstance(t, tuple) and t and isinstance(t[0], torch.Tensor):
            return tuple(zeros(x, (None,) * x.dim()) for x in t)
        return zeros(t, s)
    return build(like, specs)


# ---------------------------------------------------------------------------
# one leaf's layouts: stored, computed on, reduced onto
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One parameter leaf's three placements on ``mesh``: ``stored`` (its
    ``DTensor``), ``compute`` (what the layers take:
    ``launch.sharding.compute_spec``) and ``grad`` (the ZeRO-3 block its
    gradient is reduced onto), and the axes over which the gradient of the
    compute block is still a partial sum (:func:`leaf_plans`)."""

    mesh: Any
    stored: Tuple
    compute: Tuple
    grad: Tuple
    partial: Tuple[str, ...]

    def cycle(self) -> "LeafPlan":
        """The plan of one cycle's slice of a stacked leaf."""
        return dataclasses.replace(self, stored=self.stored[1:],
                                   compute=self.compute[1:],
                                   grad=self.grad[1:])

    def to_compute(self, block: torch.Tensor) -> torch.Tensor:
        """The stored block turned into the compute block: gathered over
        the axes the compute layout drops, narrowed to the ones it adds."""
        return to_compute(block, self.stored, self.compute, self.mesh)

    def to_grad(self, g: torch.Tensor, dtype) -> torch.Tensor:
        """The compute block's gradient reduced onto the grad block, in
        ``dtype``: a reduce-scatter over the partial axes along the
        dimension the grad layout shards over them, a slice along any
        other sharded one, an all-reduce over partial axes left over."""
        g = g.to(dtype)
        partial = list(self.partial)
        for i, (c, r) in enumerate(zip(self.compute, self.grad)):
            ac, ar = _entry_axes(c), _entry_axes(r)
            if ac == ar:
                continue
            if ac:
                raise ValueError(f"dim {i}: no reduction from {c} to {r}")
            if all(a in partial for a in ar):
                g = reduce_scatter(g, axis_group(self.mesh, ar), i)
                partial = [a for a in partial if a not in ar]
            elif not any(a in partial for a in ar):
                n = axes_size(self.mesh, ar)
                size = g.shape[i] // n
                g = g.narrow(i, axis_index(self.mesh, ar) * size, size)
            else:
                raise ValueError(f"dim {i}: {ar} mixes partial axes")
        if partial:
            g = all_reduce(g, axis_group(self.mesh, tuple(partial)))
        return g


def leaf_plans(params, mesh, cfg: Optional[ArchConfig],
               sh: Optional[ActSharding]) -> Dict[Tuple[str, ...], LeafPlan]:
    """{path: :class:`LeafPlan`} of every leaf of a ``DTensor`` parameter
    tree.  ``partial``, the axes over which a compute block's gradient is
    a partial sum:

      * the dp axes, for every leaf but the experts (each dp rank computes
        its rows);
      * and ``model``, for a whole leaf whose gradient differs from rank
        to rank of ``model``: a whole leaf of a block whose other weights
        split over ``model`` (:data:`SPLIT_BLOCKS`), which every rank
        narrows to its part (``bq``/``bk``/``bv`` through
        ``layers.block_of``, the RG-LRU's ``lam``, the mLSTM's gates when
        its heads do not divide) or uses for its heads alone (``wk``/``wv``
        where the KV heads do not divide).  Each rank's gradient is nonzero
        only on its part: reduced over dp alone it would be that part of
        the gradient, which no loss would show.  Under ``seq_par`` every
        weight of a decoder layer and the final norm, which a rank
        computes whole on its rows, but the MoE's, which takes the tokens
        whole;
      * none, for the experts, whose gradients the MoE reduces itself.

    A leaf that keeps its ``model`` block is no partial sum over
    ``model`` (only this rank computes with it), and the norms of the
    replicated hidden states get the same gradient on every ``model`` rank
    (``sum_gradients`` follows them), so ``to_grad`` slices theirs."""
    dp = dp_axes(mesh)
    grad_specs = params_shardings(params, mesh, cfg, policy="zero3")
    tp = sh is not None and sh.mesh is not None and \
        axis_sizes(mesh)["model"] > 1
    seq_par = tp and seq_parallel(sh)
    compute = {}
    for path, p in flatten(params):
        if p.device_mesh != mesh:
            raise ValueError(f"{'/'.join(path)}: on another mesh")
        compute[path] = compute_spec(path, spec_of(p), tuple(p.shape), mesh,
                                     sh)

    def keeps_model(path):
        return any("model" in _entry_axes(e) for e in compute[path])

    def partial_over_model(path):
        if not tp or keeps_model(path):
            return False
        if seq_par:
            decoder = path[0] == "cycles" or path[0].startswith("tail_")
            moe = cfg is not None and cfg.moe is not None and "ffn" in path
            return (decoder and not moe) or path == ("final_norm",)
        return len(path) > 1 and path[-2] in SPLIT_BLOCKS and any(
            keeps_model(q) for q in compute if q[:-1] == path[:-1])

    out = {}
    for path, p in flatten(params):
        grad, co = _at(grad_specs, path), compute[path]
        if sh is not None and sh.moe_mesh is not None and is_expert(
                path, p.dim()):
            if not same_layout(co, grad):
                raise ValueError(
                    f"{'/'.join(path)}: the expert-parallel layout {co}"
                    f" differs from the ZeRO-3 placement {grad} (the "
                    "experts or their F dim do not divide the mesh)")
            partial = ()
        else:
            partial = dp + (("model",) if partial_over_model(path) else ())
        # a sum over one rank is the block itself
        partial = tuple(a for a in partial if axes_size(mesh, a) > 1)
        out[path] = LeafPlan(mesh, spec_of(p), co, grad, partial)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _Gather(torch.autograd.Function):
    """FSDP's gather of one leaf: forward ``plan.to_compute(block)``;
    backward adds ``plan.to_grad(g)`` into the accumulator ``acc`` (a
    float32 block of the ZeRO-3 placement) and gives ``token`` (the one
    tensor that requires a gradient, so that autograd records the gather)
    a zero."""

    @staticmethod
    def forward(ctx, token, block, plan, acc):
        ctx.plan, ctx.acc = plan, acc
        out = plan.to_compute(block)
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(ctx, g):
        ctx.acc.add_(ctx.plan.to_grad(g, ctx.acc.dtype))
        return torch.zeros((), dtype=F32, device=g.device), None, None, None


def make_sharded_step(cfg: ArchConfig, opt, ts, sh: Optional[ActSharding]):
    """``train_step(params, opt_state, batch)`` over ``DTensor`` parameters
    and state (see the module docstring); called by
    ``train_step.make_train_step`` when the parameters are ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    from repro_torch.training.train_step import _chunked_xent

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        mesh = leaves(params)[0].device_mesh
        if sh is not None and sh.mesh is not None and \
                axis_sizes(sh.mesh) != axis_sizes(mesh):
            raise ValueError(f"sh.mesh {axis_sizes(sh.mesh)} is not the "
                             f"parameters' mesh {axis_sizes(mesh)}")
        if sh is not None and sh.moe_mesh is not None and (
                tuple(sh.moe_mesh.mesh_dim_names) != tuple(
                    mesh.mesh_dim_names)
                or tuple(sh.moe_mesh.shape) != tuple(mesh.shape)):
            raise ValueError("sh.moe_mesh is not the parameters' mesh")
        dp = dp_axes(mesh)
        ndp = axes_size(mesh, dp)
        if cfg.moe is not None and ndp > 1 and (sh is None
                                                or sh.moe_mesh is None):
            raise ValueError(
                "a MoE configuration sharded over dp needs sh.moe_mesh "
                "(act_sharding sets it): moe_ffn on each rank's rows would "
                "route at another capacity than the global batch")
        plans = leaf_plans(params, mesh, cfg, sh)
        paths = [path for path, _ in flatten(params)]
        blocks = local_tree(params)
        dev = leaves(blocks)[0].device
        acc = {path: torch.zeros(
            local_shape(tuple(_at(params, path).shape), plans[path].grad,
                        mesh), dtype=ts.accum_dtype, device=dev)
            for path in paths}
        token = torch.zeros((), dtype=F32, device=dev, requires_grad=True)

        # not a recursive closure: its reference cycle would keep ``acc``
        # alive after the step until the garbage collector ran
        def gather(tree, prefix, cycle):
            def leaf(t, path):
                plan, a = plans[path], acc[path]
                if cycle is not None:
                    plan, a = plan.cycle(), a[cycle]
                return _Gather.apply(token, t, plan, a)
            return _map_with_path(lambda path, t: leaf(t, path), tree,
                                  tuple(prefix))

        whole = {k: v.full_tensor() if isinstance(v, DTensor) else v
                 for k, v in batch.items()}
        rows = next(iter(whole.values())).shape[0]
        n_mb = ts.microbatches
        mb = rows // n_mb
        split = mb % ndp == 0
        if not split and cfg.moe is not None and sh is not None \
                and sh.moe_mesh is not None:
            raise ValueError(f"a microbatch of {mb} rows does not split over "
                             f"{ndp} dp ranks")
        mine = mb // ndp if split else mb
        first = axis_index(mesh, dp) * mine if (split and dp) else 0
        weight = mine / mb if split else 1.0 / ndp
        loss = torch.zeros((), dtype=F32, device=dev)
        for i in range(n_mb):
            lo = i * mb + first
            part = {k: v[lo:lo + mine] for k, v in whole.items()}
            mb_loss = _chunked_xent(blocks, cfg, part, sh, ts.remat,
                                    gather=gather)
            torch.autograd.grad(mb_loss * weight, token)
            loss = loss + mb_loss.detach() * weight
        if dp:
            loss = all_reduce(loss, axis_group(mesh, dp))
        if n_mb > 1:
            loss = loss / n_mb
            for a in acc.values():
                a.div_(n_mb)
        grads = unflatten(params, [
            DTensor.from_local(acc[path], mesh,
                               placements(plans[path].grad, mesh),
                               run_check=False) for path in paths])
        new_params, new_state = opt.update(grads, opt_state, params)
        step = new_state.step
        return new_params, new_state, {
            "loss": loss,
            "step": step.to_local() if isinstance(step, DTensor) else step}

    return train_step


__all__ = ["is_sharded", "local_tree", "whole_tree", "state_specs",
           "shard_train_state", "init_state", "LeafPlan", "leaf_plans",
           "make_sharded_step"]
