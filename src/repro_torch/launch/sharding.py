"""Placement rules: FSDP over ``data`` x TP over ``model`` x DP over ``pod``
(the port of ``repro.launch.sharding``).

A placement is a plain tuple with a ``PartitionSpec``'s meaning: one entry
per tensor dimension, each ``None`` (whole), an axis name, or a tuple of
axis names (sharded over their product, the first the most major).
:func:`placements` turns one into ``Shard``/``Replicate`` per mesh
dimension for ``DTensor`` (:func:`spec_of` reads one back);
:func:`shard_params` cuts a whole tree into this rank's local blocks and
:func:`distribute` into ``DTensor``s; :func:`narrow_to` and
:func:`gather_to` move a block between two placements, :func:`to_compute`
does both, and :func:`narrow_tree` narrows a whole tree (a prefill's cache
into the decode layout).

The serving entry points and the sharded train step compute on each
rank's *compute block* of a parameter (:func:`compute_spec`): its
placement with the dp axes dropped
(ZeRO-3's shard gathered), keeping ``model`` where the layers split the
work over it (attention by heads, the gated MLP by its FFN width, the
embedding and head by vocabulary, the recurrent mixers by channels); every
other weight, and every weight of a sequence-parallel model but the
embedding and head, is gathered whole.
The MoE's experts take ``moe_ffn_shard_map``'s layout.
:func:`serving_gather` turns a ``DTensor`` tree into the blocks and the
per-cycle gather that ``models.forward``, ``prefill`` and ``decode_step``
take.

The rules, name patterns and divisibility tests are the JAX package's
(``repro/launch/sharding.py``): a dimension is sharded only when it
divides evenly by the axis size, otherwise it stays whole (internvl2's 14
heads and odd 151655 vocabulary replicate over ``model`` while its FFN
shards).

  * weights:     second/contract dim -> model (TP), other large dim -> data
                 (FSDP)
  * MoE experts: expert dim -> model (EP), the FFN-hidden dim -> data
  * activations: batch -> (pod, data), heads/ffn/expert dims -> model
  * KV caches:   batch -> (pod, data); kv-head dim -> model when divisible

Every function reads only a mesh's axis names and sizes
(``launch.mesh.axis_sizes``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import axes_size, axis_group, axis_index, \
    axis_sizes, dp_axes
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import ActSharding
from repro_torch.models.moe import ep_specs

Spec = Tuple[Any, ...]


def _fits(dim: int, mesh, axes) -> bool:
    n = axes_size(mesh, axes)
    return dim % n == 0 and dim >= n


ATTN_Q = ("wq", "bq")
ATTN_KV = ("wk", "wv", "bk", "bv")
ATTN_O = ("wo",)


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               cfg: Optional[ArchConfig] = None,
               dp_override=None) -> Spec:
    """The placement of one parameter, by name pattern + divisibility.

    Attention projections are TP-sharded over ``model`` only when the head
    count divides the axis; head-indivisible architectures replicate the
    attention weights over ``model`` and keep TP for the FFN (the JAX
    package's reason: a head_dim shard makes every score einsum reduce a
    (B, H, Sq, Sk) float32 tensor across ranks).
    """
    dp = dp_axes(mesh) if dp_override is None else dp_override
    dp = dp if dp else None
    stacked = "cycles" in path or "layers" in path  # leading cycle dim
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape

    def ok(i, axes):
        return _fits(core[i], mesh, axes)

    name = path.rsplit("/", 1)[-1]
    model_n = axis_sizes(mesh)["model"]
    heads_div = cfg is not None and cfg.num_heads % model_n == 0
    kv_div = cfg is not None and cfg.num_kv_heads % model_n == 0

    if len(core) == 1:
        return (*lead, None)                        # norms, biases, lam

    if name in ("embed", "head"):
        v_dim, d_dim = (0, 1) if name == "embed" else (1, 0)
        spec = [None, None]
        if ok(v_dim, "model"):
            spec[v_dim] = "model"
        if ok(d_dim, dp):
            spec[d_dim] = dp
        return tuple(spec)

    if name in ("w_router",):
        return (*lead, dp if ok(0, dp) else None, None)

    if len(core) == 3:                              # MoE experts
        # EP over model on the expert dim; the second shard goes on the
        # FFN-hidden dim over data, not on d_model (the JAX package's
        # measured reason: gathering d_model-sharded experts every
        # microbatch costs ~30x the traffic)
        e = "model" if ok(0, "model") else None
        f_dim = 2 if name in ("w_gate", "w_up") else 1   # w_down: (E, F, D)
        spec = [e, None, None]
        if ok(f_dim, dp):
            spec[f_dim] = dp
        return (*lead, *spec)

    if len(core) == 2:
        if name in ATTN_Q or name in ATTN_KV or name in ATTN_O:
            head_ok = kv_div if name in ATTN_KV else heads_div
            out_side = name in ATTN_O
            i, j = (0, 1) if out_side else (1, 0)
            spec = [None, None]
            if head_ok and ok(i, "model"):
                spec[i] = "model"
            if ok(j, dp):
                spec[j] = dp
            return (*lead, *spec)
        # contract-dim heuristic: output-side matrices have the
        # model-parallel dim first, input-side ones last
        out_side = name in ("w_down", "w_out", "w_shared_down")
        i, j = (0, 1) if out_side else (1, 0)
        spec = [None, None]
        if ok(i, "model"):
            spec[i] = "model"
        if ok(j, dp):
            spec[j] = dp
        return (*lead, *spec)

    return (*lead, *(None,) * len(core))


ZERO1_MAX_PARAMS = 2e9   # replicate weights over dp below this size


def zero_policy(cfg: Optional[ArchConfig]) -> str:
    """ZeRO-1 (weights replicated over dp, optimizer states sharded) for
    models of at most 2e9 parameters, ZeRO-3 above (the JAX package's
    measured trade: re-gathering a 2.5B model's weights every microbatch
    costs far more traffic than holding a replica)."""
    if cfg is None:
        return "zero3"
    return "zero1" if cfg.n_params() <= ZERO1_MAX_PARAMS else "zero3"


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def params_shardings(abstract, mesh, cfg: Optional[ArchConfig] = None,
                     policy: Optional[str] = None):
    """The tree of placements of a parameter tree (any tree of tensors
    with ``.shape``; ``abstract_params``' meta tensors need no memory).

    ``policy``: "zero3" shards weights over dp (the default for big
    models), "zero1" replicates them over dp (optimizer states take
    "zero3" regardless).  Sequence-parallel architectures
    (head-indivisible) under ZeRO-1 replicate everything but the
    embedding and head, as in JAX.
    """
    policy = policy or zero_policy(cfg)
    dp_override = () if policy == "zero1" else None
    seq_par_z1 = (policy == "zero1" and cfg is not None
                  and cfg.num_heads % axis_sizes(mesh)["model"] != 0)

    def visit(path, leaf):
        pstr = "/".join(path)
        name = pstr.rsplit("/", 1)[-1]
        if seq_par_z1 and name not in ("embed", "head"):
            return (None,) * len(leaf.shape)
        return param_spec(pstr, tuple(leaf.shape), mesh, cfg,
                          dp_override=dp_override)

    return _map_with_path(visit, abstract)


def act_sharding(cfg: ArchConfig, mesh, batch: int,
                 seq: Optional[int] = None) -> ActSharding:
    """Activation placements: TP on heads when they divide ``model``;
    otherwise sequence parallelism (the sequence over ``model``) for
    dense-attention shapes that pass ``seq``; the expert-parallel MoE on
    ``mesh`` for MoE configurations.  The rules are the JAX package's,
    with its reasons there.  ``mesh`` is kept (``ActSharding.mesh``): the
    serving entry points and the sharded train step split their work over
    its ``model`` axis."""
    dp = dp_axes(mesh)
    model_n = axis_sizes(mesh)["model"]
    bdim = dp if batch % axes_size(mesh, dp) == 0 else None
    heads_div = cfg.num_heads % model_n == 0
    attn_only = all(k in ("attn", "swa") for k in cfg.layer_kinds())
    seq_par = ((not heads_div) and attn_only and seq is not None
               and seq % model_n == 0)
    sdim = "model" if seq_par else None
    heads = "model" if heads_div else None
    ffn_div = cfg.d_ff % model_n == 0 and cfg.d_ff > 0
    vocab_div = cfg.vocab_size % model_n == 0
    kv_div = cfg.num_kv_heads % model_n == 0
    return ActSharding(
        mesh=mesh,
        hidden=(bdim, sdim, None),
        heads=(bdim, sdim, heads, None),
        kv=(bdim, sdim, "model" if kv_div else None, None),
        ffn=(bdim, sdim, "model" if (ffn_div and not seq_par) else None),
        expert=("model", None, None) if cfg.moe else None,
        logits=(bdim, sdim if not vocab_div else None,
                "model" if vocab_div else None),
        moe_mesh=mesh if cfg.moe else None,
        moe_dp_axes=dp if cfg.moe else (),
    )


def batch_shardings(cfg: ArchConfig, mesh, batch: int,
                    kind: str) -> Dict[str, Spec]:
    """Placements of the input batch: its rows over the dp axes."""
    dp = dp_axes(mesh)
    bdim = dp if batch % axes_size(mesh, dp) == 0 else None
    out: Dict[str, Spec] = {"tokens": (bdim, None)}
    if kind == "train":
        out["labels"] = (bdim, None)
    if cfg.frontend == "patch":
        out["embeds"] = (bdim, None, None)
    if cfg.frontend == "frames":
        out["frames"] = (bdim, None, None)
    return out


def cache_shardings(cache_abstract, cfg: ArchConfig, mesh, batch: int,
                    for_decode: bool = True):
    """Placements of a cache tree: the batch over dp, kv-head or state
    dims over ``model`` when divisible.  K/V whose heads do not divide
    shard their head_dim instead, for decode only (``for_decode=False``,
    the prefill's output, keeps head_dim whole), as in JAX."""
    dp = dp_axes(mesh)
    bdim = dp if batch % axes_size(mesh, dp) == 0 else None
    model_n = axis_sizes(mesh)["model"]

    def visit(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name == "pos":
            return ()
        lead = (None,) if "cycles" in path else ()
        core = shape[1:] if lead else shape
        if name in ("k", "v", "xk", "xv"):
            if core[2] % model_n == 0:
                return (*lead, bdim, None, "model", None)
            dh = "model" if (for_decode and core[3] % model_n == 0) else None
            return (*lead, bdim, None, None, dh)
        if name == "c" and len(core) == 4:          # mLSTM (B, H, Dh, Dh)
            dh = "model" if core[2] % model_n == 0 else None
            return (*lead, bdim, None, dh, None)
        if name == "n" and len(core) == 3:          # (B, H, Dh)
            dh = "model" if core[2] % model_n == 0 else None
            return (*lead, bdim, None, dh)
        if name == "enc_out":
            return (bdim, None, None)
        if len(core) >= 2 and core[-1] % model_n == 0:
            return (*lead, bdim, *(None,) * (len(core) - 2), "model")
        return (*lead, bdim, *(None,) * (len(core) - 1))

    return _map_with_path(visit, cache_abstract)


def moe_param_specs(params, mesh, model_axis: str = "model"):
    """Placements for a forward with ``ActSharding(moe_mesh=mesh)``: the
    expert weights in ``moe_ffn_shard_map``'s layout (experts over
    ``model_axis``, the FFN-hidden dim over the dp axes), every other
    parameter whole on each rank."""
    specs = ep_specs(dp_axes(mesh), model_axis)

    def visit(path, leaf):
        if is_expert(path, leaf.dim()):
            return (None,) * (leaf.dim() - 3) + tuple(specs[path[-1]])
        return (None,) * leaf.dim()

    return _map_with_path(visit, params)


# ---------------------------------------------------------------------------
# compute blocks: what the layers take of each parameter
# ---------------------------------------------------------------------------

EXPERTS = ("w_gate", "w_up", "w_down")
FFN_TP = ("w_gate", "w_up", "w_down")
RECURRENT = ("rglru", "mlstm", "slstm")


def is_expert(path: Tuple[str, ...], ndim: int) -> bool:
    """Whether the leaf at ``path`` is one of an MoE's stacked expert
    weights ((E, D, F) or (E, F, D), after any cycle axis)."""
    lead = 1 if "cycles" in path or "layers" in path else 0
    return "ffn" in path and path[-1] in EXPERTS and ndim == lead + 3


def _tp_leaf(path: Tuple[str, ...], ndim: int) -> bool:
    """Whether the layers split this leaf's work over ``model``: attention
    projections (self-, cross- and the encoder's), the gated MLP's three
    matrices, the embedding and the head."""
    name = path[-1]
    lead = 1 if "cycles" in path or "layers" in path else 0
    if len(path) == 1 and name in ("embed", "head"):
        return True
    if ("attn" in path or "xattn" in path) and name in (
            ATTN_Q + ATTN_KV + ATTN_O):
        return True
    return "ffn" in path and name in FFN_TP and ndim == lead + 2


def _drop_axes(spec: Spec, axes) -> Spec:
    def entry(e):
        kept = tuple(a for a in _entry_axes(e) if a not in axes)
        return None if not kept else kept[0] if len(kept) == 1 else kept
    return tuple(entry(e) for e in spec)


def seq_parallel(sh: Optional[ActSharding]) -> bool:
    """Whether ``sh`` shards the hidden states' sequence over ``model``
    (``act_sharding``'s ``seq_par``)."""
    return (sh is not None and sh.hidden is not None and len(sh.hidden) > 1
            and "model" in _entry_axes(sh.hidden[1]))


def compute_spec(path: Tuple[str, ...], spec: Spec, shape: Tuple[int, ...],
                 mesh, sh: Optional[ActSharding]) -> Spec:
    """The placement of the block the layers compute with, for a
    parameter of ``shape`` at ``path`` stored under ``spec`` (see the
    module docstring): the experts in ``moe_ffn_shard_map``'s layout when
    ``sh.moe_mesh`` is set; a recurrent mixer's weight split by channels
    over ``model`` as :func:`param_spec`'s contract-dim rule splits it,
    whatever it is stored under (its states are split so in
    ``cache_shardings``; a weight stored whole, as ZeRO-1 of a model whose
    heads do not divide ``model`` replicates it, is narrowed to its block);
    else ``spec`` without the dp axes, and without ``model`` too unless the
    layers split the leaf over it (never under sequence parallelism, but
    for the embedding and head; never without ``sh.mesh``, where every
    rank computes whole)."""
    if sh is not None and sh.moe_mesh is not None and is_expert(path,
                                                                len(spec)):
        return (None,) * (len(spec) - 3) + tuple(
            ep_specs(dp_axes(mesh))[path[-1]])
    tp = sh is not None and sh.mesh is not None
    if tp and any(m in path for m in RECURRENT) and not seq_parallel(sh):
        return param_spec("/".join(path), tuple(shape), mesh,
                          dp_override=())
    keep_model = tp and _tp_leaf(path, len(spec)) and (
        not seq_parallel(sh) or (len(path) == 1
                                 and path[-1] in ("embed", "head")))
    drop = set(dp_axes(mesh)) | (set() if keep_model else {"model"})
    return _drop_axes(spec, drop)


def compute_specs(specs, params, mesh, sh: Optional[ActSharding]):
    """:func:`compute_spec` of every leaf of a tree of placements
    (``params_shardings``) of the tree ``params`` (tensors of any device,
    ``meta`` too: only their shapes are read): cut a whole tree with
    ``shard_params(params, mesh, compute_specs(...))`` for the blocks the
    layers take directly."""
    def walk(tree, leaves, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, leaves[k], path + (str(k),))
                    for k, v in tree.items()}
        return compute_spec(path, tuple(tree), tuple(leaves.shape), mesh, sh)
    return walk(specs, params)


def to_compute(block: torch.Tensor, stored: Spec, compute: Spec,
               mesh) -> torch.Tensor:
    """The block under ``compute`` of the block ``block`` this rank holds
    under ``stored``: gathered over the axes ``compute`` drops, narrowed to
    the ones it adds (a view where nothing is gathered)."""
    kept = tuple(c if _entry_axes(s) else None
                 for s, c in zip(stored, compute))
    x = gather_to(block, stored, kept, mesh)
    return narrow_to(x, kept, compute, mesh)


def serving_gather(params, sh: Optional[ActSharding]):
    """(blocks, gather) for a tree of ``DTensor`` parameters (placed by
    ``params_shardings`` or any other placement): ``blocks`` is the tree of
    local blocks, and ``gather(subtree, path, cycle)`` (``forward``'s
    ``gather`` hook) turns a subtree of them into its compute blocks
    (:func:`compute_spec`), cycle ``cycle`` of a stacked subtree when it is
    not None; None when every block is its compute block (a 1x1 mesh).
    No autograd: the serving path."""
    stored, shapes = {}, {}
    mesh = None

    def visit(path, t):
        nonlocal mesh
        if mesh is None:
            mesh = t.device_mesh
        elif t.device_mesh != mesh:
            raise ValueError(f"{'/'.join(path)}: on another mesh")
        stored[path] = spec_of(t)
        shapes[path] = tuple(t.shape)
        return t.to_local()

    blocks = _map_with_path(visit, params)
    if sh is not None and sh.mesh is not None and \
            axis_sizes(sh.mesh) != axis_sizes(mesh):
        raise ValueError(f"sh.mesh {axis_sizes(sh.mesh)} is not the "
                         f"parameters' mesh {axis_sizes(mesh)}")
    # axes of size 1 split nothing: a leaf whose compute block differs from
    # its stored block only over them is used as it is
    ones = {a for a, n in axis_sizes(mesh).items() if n == 1}
    compute = {}
    for path, spec in stored.items():
        co = compute_spec(path, spec, shapes[path], mesh, sh)
        if _drop_axes(co, ones) != _drop_axes(spec, ones):
            compute[path] = _drop_axes(spec, ones), _drop_axes(co, ones)
    if not compute:
        return blocks, None

    def gather(tree, prefix, cycle):
        def leaf(path, t):
            if path not in compute:
                return t
            st, co = compute[path]
            if cycle is not None:
                st, co = st[1:], co[1:]
            return to_compute(t, st, co, mesh)
        return _map_with_path(leaf, tree, tuple(prefix))

    return blocks, gather


def narrow_tree(tree, specs_from, specs_to, mesh):
    """Each leaf of a tree of this rank's blocks under ``specs_from``
    narrowed to its block under ``specs_to`` (:func:`narrow_to`, no
    communication), copied where it shrinks so that the larger block can be
    freed: a prefill's cache (``cache_shardings(..., for_decode=False)``)
    into the decode layout."""
    if isinstance(tree, dict):
        return {k: narrow_tree(v, specs_from[k], specs_to[k], mesh)
                for k, v in tree.items()}
    out = narrow_to(tree, tuple(specs_from), tuple(specs_to), mesh)
    return out if out.shape == tree.shape else out.contiguous()


# ---------------------------------------------------------------------------
# placements on a mesh: DTensor's form, local shapes and blocks
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """``spec`` as ``DTensor`` placements, one per mesh dimension:
    ``Shard(i)`` where the dimension shards tensor dim ``i``, else
    ``Replicate()``.  An entry of several axes must list them in the mesh's
    order (``DTensor`` shards a dim over mesh dims major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placement {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"placement {spec}: axis {names[j]} used "
                                 "twice")
            out[j] = Shard(i)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``;
    a sharded dimension must divide evenly (as ``shard_map`` asks)."""
    if len(spec) > len(shape):
        raise ValueError(f"placement {spec} has more entries than {shape}")
    out = list(shape)
    for i, entry in enumerate(spec):
        n = axes_size(mesh, _entry_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {shape} does not divide over "
                             f"{entry} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def local_bytes(shape: Tuple[int, ...], dtype: torch.dtype, spec: Spec,
                mesh) -> int:
    """Bytes of one rank's block."""
    return math.prod(local_shape(shape, spec, mesh)) * \
        torch.empty((), dtype=dtype).element_size()


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor ``x`` under ``spec`` (a copy
    that owns its memory)."""
    block = x
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = axes_size(mesh, axes)
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"over {entry} ({n} ranks)")
        size = x.shape[i] // n
        block = block.narrow(i, axis_index(mesh, axes) * size, size)
    return block.clone(memory_format=torch.contiguous_format)


def spec_of(t) -> Spec:
    """The placement of a ``DTensor`` as a spec tuple (the inverse of
    :func:`placements`): one entry per tensor dimension, ``None``, an axis
    name, or a tuple of names in the mesh's order."""
    names = list(t.device_mesh.mesh_dim_names)
    per_dim = [[] for _ in range(t.ndim)]
    for j, pl in enumerate(t.placements):
        if pl.is_shard():
            per_dim[pl.dim].append(names[j])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def same_layout(a: Spec, b: Spec) -> bool:
    """Whether two specs place every dimension alike (``"data"`` and
    ``("data",)`` are one placement)."""
    return len(a) == len(b) and all(
        _entry_axes(x) == _entry_axes(y) for x, y in zip(a, b))


def _relayout(a: Spec, b: Spec):
    """(dim, axes of ``a``, axes of ``b``) of each dimension the two specs
    place differently; one of the two must keep it whole."""
    if len(a) != len(b):
        raise ValueError(f"placements {a} and {b} have other ranks")
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        ax, ay = _entry_axes(x), _entry_axes(y)
        if ax != ay:
            if ax and ay:
                raise ValueError(f"dim {i}: no relayout from {x} to {y}")
            out.append((i, ax, ay))
    return out


def narrow_to(x: torch.Tensor, spec_from: Spec, spec_to: Spec,
              mesh) -> torch.Tensor:
    """This rank's block under ``spec_to`` of the block ``x`` it holds under
    ``spec_from``, where ``spec_to`` only shards dimensions that
    ``spec_from`` keeps whole: a view, no copy and no communication."""
    for i, ax, ay in _relayout(spec_from, spec_to):
        if ax:
            raise ValueError(f"narrow_to: dim {i} is sharded over {ax} in "
                             f"{spec_from}, whole in {spec_to}")
        size = x.shape[i] // axes_size(mesh, ay)
        if size * axes_size(mesh, ay) != x.shape[i]:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"over {ay}")
        x = x.narrow(i, axis_index(mesh, ay) * size, size)
    return x


def gather_to(x: torch.Tensor, spec_from: Spec, spec_to: Spec,
              mesh) -> torch.Tensor:
    """The block under ``spec_to`` assembled from every rank's block ``x``
    under ``spec_from`` (a tiled all-gather over each axis group that
    ``spec_to`` drops, of more than one rank; ``spec_to`` shards nothing
    ``spec_from`` keeps whole).  Not recorded by autograd."""
    from repro_torch.mesh_axes import all_gather

    for i, ax, ay in _relayout(spec_from, spec_to):
        if ay:
            raise ValueError(f"gather_to: dim {i} is whole in {spec_from}, "
                             f"sharded over {ay} in {spec_to}")
        if axes_size(mesh, ax) == 1:
            continue
        with torch.no_grad():
            x = all_gather(x, axis_group(mesh, ax), i)
    return x


def owns_block(spec: Spec, mesh) -> bool:
    """Whether this rank is the first of the ranks that hold the same block
    under ``spec`` (coordinate 0 along every axis the spec does not
    shard): a sum over distinct elements counts each block once."""
    used = {a for e in spec for a in _entry_axes(e)}
    coord = mesh.get_coordinate()
    return all(c == 0 for name, c in zip(mesh.mesh_dim_names, coord)
               if name not in used)


def distribute(tree, specs, mesh):
    """A tree of ``DTensor``s on ``mesh`` from a tree of whole tensors and a
    tree of placements of the same keys (``params_shardings``; a spec
    ``()`` for a 0-d tensor).  Each local block is a view of the whole
    tensor where it can be (a 1x1 mesh copies nothing), else a copy."""
    from torch.distributed.tensor import DTensor

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(getattr(tree, f), getattr(specs, f),
                                       mesh) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute(v, s, mesh) for v, s in zip(tree,
                                                                 specs))
    whole = (None,) * tree.dim()
    block = narrow_to(tree, whole, tuple(specs) + (None,) * (
        tree.dim() - len(specs)), mesh).contiguous()
    return DTensor.from_local(block, mesh, placements(specs, mesh),
                              run_check=False)


def shard_params(params, mesh, specs):
    """This rank's local blocks of a whole parameter tree (for example
    ``params_from_jax``'s output), cut by a tree of placements of the same
    keys (``params_shardings``, ``moe_param_specs``)."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, specs[k]) for k, v in params.items()}
    return local_block(params, specs, mesh)


__all__ = ["param_spec", "zero_policy", "params_shardings", "act_sharding",
           "batch_shardings", "cache_shardings", "moe_param_specs",
           "seq_parallel", "is_expert", "compute_spec",
           "compute_specs", "to_compute",
           "serving_gather", "narrow_tree",
           "placements", "local_shape", "local_bytes", "local_block",
           "shard_params", "spec_of", "same_layout", "narrow_to",
           "gather_to", "owns_block", "distribute", "ZERO1_MAX_PARAMS"]
