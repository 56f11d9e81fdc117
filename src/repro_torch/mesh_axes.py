"""Mesh axes and the collectives the sharded functions share.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` (or a
stand-in with ``mesh_dim_names`` and ``shape``).  The axis helpers read
its axis names, sizes and this rank's coordinate; the collectives are
``jax.lax.all_to_all`` and a tiled ``jax.lax.all_gather`` over one axis's
process group (or several axes' flattened group).  Both the models and
the relational layer use them, and ``repro_torch.launch.mesh``
re-exports the axis helpers.

The collectives are differentiable (``torch.autograd.Function``s), with
the adjoints a ``shard_map`` body's collectives get in JAX:

  * :func:`all_to_all` (split = concat = dim 0): the same exchange of the
    cotangent;
  * :func:`all_gather` with ``adjoint="sum"``: a reduce-scatter (sum) of
    the cotangent over the same group.  The ranks' consumers differ (other
    tokens, other rows of a loss), so their contributions add: an FSDP
    weight, the experts' F shard, a token block;
  * :func:`all_gather` with ``adjoint="slice"``: this rank's slice of the
    cotangent.  Every rank of the group computes the same thing from the
    gathered tensor (the MoE's closing gather over ``model``, whose loss
    every model rank computes redundantly); a reduce-scatter there would
    scale the gradient by the group's size;
  * :func:`sum_gradients`: the identity, whose cotangent is summed over
    the group (an all-reduce): the entry of a replicated tensor that each
    rank of the group uses for other work (its slice of the tokens, its
    tokens' router logits, its heads or FFN columns);
  * :func:`psum` (an all-reduce: the closing sum of a row-parallel
    projection, whose ranks hold partial sums of one result): the
    identity on the cotangent.  Every rank uses the sum alike (the
    activations after it are replicated over the group), so each partial
    sum's cotangent is the sum's; the replicated input of the block takes
    :func:`sum_gradients`, as Megatron's pair of conjugate operators.

:func:`reduce_scatter` and :func:`all_reduce` are the plain collectives
(not recorded by autograd) that the sharded train step reduces its
gradients with.  On a ``gloo`` group a CUDA tensor is staged through the
host (:func:`_staged`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict

import torch

_RECORDED = {"records": None}          # the open recorder
_RECORD_LOCK = threading.Lock()


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def axis_group(mesh, axes):
    """The process group of one axis, or of several axes flattened (as
    ``shard_map``'s collectives over a tuple of axes): ``None`` when
    ``axes`` is empty."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group(0)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (major to minor, as
    ``jax.lax.axis_index`` over a tuple of axes)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes, coord = axis_sizes(mesh), mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def axes_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (1 for none)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


@contextlib.contextmanager
def recording_collectives():
    """Collect (kind, output bytes) of every collective this process runs
    while the block runs ("all-gather", "all-to-all", "all-reduce",
    "reduce-scatter"): the dry run's reckoning of a program's traffic.
    Process-wide, not per thread: on a CUDA device autograd runs the
    backward's collectives on a thread of its own."""
    outer = _RECORDED["records"]
    _RECORDED["records"] = records = []
    try:
        yield records
    finally:
        _RECORDED["records"] = outer


def _record(kind: str, out: torch.Tensor) -> torch.Tensor:
    records = _RECORDED["records"]
    if records is not None:
        with _RECORD_LOCK:
            records.append((kind, out.numel() * out.element_size()))
    return out


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on ``x`` goes through the host: a CUDA tensor
    over a ``gloo`` group (several ranks on one card, where ``nccl`` cannot
    put two ranks on one device; gloo's CUDA support covers fewer
    collectives than its host path)."""
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()            # empty_like keeps a view's strides
    if _staged(x, group):
        return _all_to_all(x.cpu(), group).to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return _record("all-to-all", out)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    if _staged(x, group):
        return _all_gather(x.cpu(), group, dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return _record("all-gather", parts[0] if len(parts) == 1
                   else torch.cat(parts, dim=dim))


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, cut along ``dim`` into
    equal blocks in rank order: this rank's block (``psum_scatter(...,
    scatter_dimension=dim, tiled=True)``).  Not recorded by autograd."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    if _staged(x, group):
        return reduce_scatter(x.cpu(), group, dim).to(x.device)
    xm = x.detach().movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    # the name of torch 2.13 and later, the other of the earlier ones
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, xm, group=group)
    return _record("reduce-scatter", out.movedim(0, dim))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the largest) of ``x`` over ``group``'s ranks,
    in a new tensor.  Not recorded by autograd."""
    import torch.distributed as dist

    if _staged(x, group):
        return all_reduce(x.cpu(), group, op).to(x.device)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return _record("all-reduce", out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, adjoint):
        ctx.group, ctx.dim, ctx.adjoint = group, dim, adjoint
        ctx.size = x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        if ctx.adjoint == "sum":
            out = reduce_scatter(g, ctx.group, ctx.dim)
        else:
            out = g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.size,
                           ctx.size)
        return out, None, None, None


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)``: block j of the
    leading axis goes to rank j of ``group``; blocks arrive in rank
    order.  Its adjoint is the same exchange."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int,
               adjoint: str = "sum") -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)`` over ``group``'s
    ranks in order.  ``adjoint`` is ``"sum"`` (a reduce-scatter: the
    ranks use the result for different work) or ``"slice"`` (this rank's
    slice: every rank computes the same thing from it); see the module
    docstring."""
    if adjoint not in ("sum", "slice"):
        raise ValueError(f"all_gather: adjoint {adjoint!r}")
    return _AllGather.apply(x, group, dim, adjoint)


def sum_gradients(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (see the module
    docstring)."""
    return _SumGradients.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum`` over ``group``: the sum of every rank's ``x``, in
    ``x``'s dtype (a bfloat16 input is summed in float32 and rounded once).
    Its adjoint is the identity (see the module docstring)."""
    if x.dtype == torch.bfloat16:
        return _Psum.apply(x.to(torch.float32), group).to(x.dtype)
    return _Psum.apply(x, group)


__all__ = ["axis_sizes", "axis_group", "axis_index", "axes_size",
           "all_to_all", "all_gather", "sum_gradients", "psum",
           "reduce_scatter", "all_reduce", "recording_collectives"]
