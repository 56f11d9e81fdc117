"""Multi-pod dry run: every (arch x shape x mesh) cell's per-device
accounting on a fake process group (the port of ``repro.launch.dryrun``).

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod] [--both-meshes] [--out dryrun_results]

A cell builds the production mesh (16x16 ``("data", "model")``, or
2x16x16 with ``"pod"``) on a ``fake`` process group of 256 or 512 ranks,
places every input by ``launch.sharding``'s rules, and runs the step once
on ``meta`` tensors at the global shapes (no memory, no device).  Nothing
here compiles, so each field of the JAX report
(``repro/launch/dryrun.py``) is filled as follows, per device:

  * ``argument_bytes``: the exact sum of the local blocks the placements
    give the step's arguments: parameters (``params_shardings``, ZeRO-1 or
    -3 by ``zero_policy``), the optimizer state (AdamW's step, and m and v
    in float32 under the ZeRO-3 placements) and the batch for train;
    parameters and batch for prefill; parameters, cache and the token
    (whole on every rank) for decode.  The cache's layout is
    ``cache_shardings``', the port's: the attention caches by KV heads (or
    ``head_dim``), the recurrent mixers' states by channels (the mLSTM's
    memory by its key rows).
  * ``output_bytes``: the local blocks of the outputs: parameters and
    optimizer state (train); the last logits (B, V) float32, whole, and the
    cache (prefill, decode).
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over rank 0's
    program (matmul, bmm and convolution FLOPs, 2 M N K; no elementwise
    FLOPs, as the reference's HLO count), with ``act_sharding``'s
    ``ActSharding`` (its mesh the production mesh) on ``meta`` compute
    blocks of rank 0 (``sharding.compute_specs``) and its blocks of the
    batch and cache: the tensor-parallel program at its local shapes (the
    recurrent mixers at their channel blocks), the MoE through
    ``moe_ffn_shard_map``.  Prefill and decode: ``prefill`` /
    ``decode_step``.  Train: the sharded train step's program
    (``training.sharded``) over ``microbatches_for`` microbatches of its
    dp block of the batch: the forward, ``remat``'s recompute and the
    backward (``train_step._chunked_xent``, the loss vocab-parallel), then
    the AdamW update over its ZeRO-3 blocks.
  * ``bytes_accessed``: every operation of that run reads each tensor
    operand in full and writes each output in full (view operations move
    nothing), summed: the traffic of the unfused eager program, an upper
    bound of what a fused one moves.
  * ``temp_bytes``: null.  There is no compiler's buffer assignment to
    read it from, and no reckoning of the live activations is made.
  * ``collective_bytes`` (each collective's output bytes, as the
    reference's HLO count), reckoned from the placements and the policy:
      - the weights' gathers, each leaf to its compute block (over dp, and
        over ``model`` too for a weight the layers do not split): once a
        prefill or decode step, per microbatch twice in training (the
        forward, and the backward with remat's recompute).  Under ZeRO-1
        the updated parameters are gathered over dp once a step too.
      - ``reduce-scatter`` (train): each gradient, per microbatch, onto the
        optimizer state's ZeRO-3 block, in float32 (the accumulation
        type); one a leaf, also where the leaf is a partial sum over
        ``model`` too (the leaves each rank narrows, every weight under
        sequence parallelism), whose reduction over ``model`` is not
        reckoned apart.  The experts' reductions are the MoE's own (below).
      - every collective rank 0's program runs
        (``mesh_axes.recording_collectives``, each by its kind): the
        row-parallel projections' and the vocab-parallel embedding's
        ``psum``s (float32 all-reduces), the decode's ``head_dim`` score
        all-reduces and its query and output ``all_to_all``s, the
        vocabulary gathers of the logits, sequence parallelism's K/V and
        hidden gathers, the MoE's exchanges, combine gathers and expert
        gathers, and the recurrent mixers' exchanges (the RG-LRU's gate
        input gather; the mLSTM's query and key ``all_to_all``s, value,
        gate and output gathers and the float32 all-reduce of its partial
        sums over the key rows).  In training that is the forward's, the
        recompute's and the backward's: there each column-parallel
        block's ``sum_gradients`` all-reduce, the adjoints of the gathers
        and exchanges, and the vocab-parallel loss's all-reduces of the
        row maxima and of the sums.
      - not reckoned: the MoE's collectives where the EP rule fails.
      - ``total``: their sum.

The run also records the activations the model places
(``layers.recording_placements``: each activation's local block under
``act_sharding``'s fields) and reports the largest per-device block of
each field under ``activations``.

Nothing happens at import: no environment variable, no process group.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.input_specs import (
    batch_specs,
    cache_specs,
    cell_is_applicable,
    token_spec,
)
from repro_torch.launch.mesh import (
    PRODUCTION_SHAPE,
    make_production_mesh,
)
from repro_torch.launch.sharding import (
    act_sharding,
    batch_shardings,
    cache_shardings,
    compute_specs,
    is_expert,
    local_bytes,
    local_shape,
    params_shardings,
    zero_policy,
)
from repro_torch.mesh_axes import recording_collectives
from repro_torch.models import SHAPES, abstract_params
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.decode import decode_step, prefill
from repro_torch.models.layers import recording_placements
from repro_torch.training.optim import AdamW
from repro_torch.training.train_step import _chunked_xent
from repro_torch.training.tree import flatten, flatten_up_to, leaves, \
    tree_map


def microbatches_for(arch: str) -> int:
    # the JAX package's table: more microbatches = smaller activations but
    # one more round of FSDP weight traffic per microbatch
    return {"qwen3-moe-235b-a22b": 8, "llama4-scout-17b-a16e": 8,
            "recurrentgemma-9b": 4, "seamless-m4t-medium": 4,
            "h2o-danube-3-4b": 4, "qwen2.5-3b": 4,
            "xlstm-1.3b": 8}.get(arch, 2)


@contextlib.contextmanager
def fake_world(ranks: int):
    """A ``fake`` default process group of ``ranks`` ranks (collectives do
    nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return [x for k in tree for x in _map2(fn, tree[k], specs[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # AdamWState
        return [x for f in tree._fields
                for x in _map2(fn, getattr(tree, f), getattr(specs, f))]
    return [fn(tree, specs)]


def tree_local_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's blocks of a tree of tensors under a tree of
    placements of the same keys."""
    return sum(_map2(lambda t, s: local_bytes(tuple(t.shape), t.dtype, s,
                                              mesh), tree, specs))


def _whole(tree):
    """Placements that keep every tensor of ``tree`` whole."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(v) for v in tree))
    return (None,) * tree.dim()


def cell_arguments(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict:
    """{role: (meta tree, placement tree)} of the step's arguments: what
    ``argument_bytes`` sums."""
    aparams = abstract_params(cfg)
    out = {"params": (aparams, params_shardings(aparams, mesh, cfg))}
    if shape.kind == "train":
        aopt = AdamW().init(aparams)
        z3 = params_shardings(aparams, mesh, cfg, policy="zero3")
        out["opt_state"] = (aopt, type(aopt)(step=(), m=z3, v=z3))
    if shape.kind in ("train", "prefill"):
        out["batch"] = (batch_specs(cfg, shape, shape.kind == "train"),
                        batch_shardings(cfg, mesh, shape.global_batch,
                                        shape.kind))
    else:
        acache = cache_specs(cfg, shape)
        out["cache"] = (acache, cache_shardings(
            acache, cfg, mesh, shape.global_batch))
        tok = token_spec(shape)
        out["token"] = (tok, _whole(tok))
    return out


def argument_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   args=None) -> int:
    """Per-device bytes of the step's arguments (see the module
    docstring)."""
    args = args or cell_arguments(cfg, shape, mesh)
    return sum(tree_local_bytes(t, s, mesh) for t, s in args.values())


def output_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh, args) -> int:
    """Per-device bytes of the step's outputs (see the module docstring;
    the prefill's cache takes the placements without the head_dim
    fallback, as the reference's ``for_decode=False``)."""
    if shape.kind == "train":
        return sum(tree_local_bytes(*args[r], mesh)
                   for r in ("params", "opt_state"))
    cache = cache_specs(cfg, shape)
    specs = cache_shardings(cache, cfg, mesh, shape.global_batch,
                            for_decode=shape.kind == "decode")
    return shape.global_batch * cfg.vocab_size * 4 + \
        tree_local_bytes(cache, specs, mesh)


def collective_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh, args,
                     microbatches: int, sh=None,
                     recorded=()) -> Dict[str, int]:
    """The reckoning of the module docstring, per device; ``recorded``:
    the (kind, bytes) of the collectives rank 0's program made."""
    aparams, p_sh = args["params"]

    def gathered(t, spec, kept):  # the block a gather gives, or nothing
        return 0 if kept == tuple(spec) else local_bytes(
            tuple(t.shape), t.dtype, kept, mesh)

    fsdp = sum(_map2(lambda t, s: gathered(t, s[0], tuple(
        c if e else None for e, c in zip(*s))), aparams,
        _zip_specs(p_sh, compute_specs(p_sh, aparams, mesh, sh))))
    out = {"all-gather": fsdp, "reduce-scatter": 0, "all-to-all": 0,
           "all-reduce": 0}
    if shape.kind == "train":
        z3 = args["opt_state"][1].m
        experts = set(_expert_paths(aparams, sh))
        grads = sum(local_bytes(tuple(t.shape), torch.float32, s, mesh)
                    for (path, t), s in zip(flatten(aparams),
                                            flatten_up_to(aparams, z3))
                    if path not in experts)
        out["all-gather"] = 2 * microbatches * fsdp + (
            tree_local_bytes(aparams, p_sh, mesh)
            if zero_policy(cfg) == "zero1" else 0)
        out["reduce-scatter"] = microbatches * grads
    for kind, nbytes in recorded:
        out[kind] += nbytes
    out["total"] = sum(out.values())
    return out


def _expert_paths(params, sh):
    """The paths of the MoE's expert weights where the expert-parallel
    MoE runs (``sh.moe_mesh``): their gradients are reduced by the MoE's
    own collectives, which the program records."""
    if sh is None or sh.moe_mesh is None:
        return []
    return [path for path, t in flatten(params) if is_expert(path, t.dim())]


def _zip_specs(a, b):
    """A tree of (spec, spec) pairs from two trees of specs."""
    if isinstance(a, dict):
        return {k: _zip_specs(a[k], b[k]) for k in a}
    return (tuple(a), tuple(b))


class _Traffic(TorchDispatchMode):
    """Bytes every operation reads and writes (its tensor operands and
    outputs in full; views move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _meta_blocks(tree, specs, mesh):
    """``meta`` tensors of rank 0's blocks of ``tree`` under ``specs``."""
    if isinstance(tree, dict):
        return {k: _meta_blocks(v, specs[k], mesh) for k, v in tree.items()}
    return torch.empty(local_shape(tuple(tree.shape), tuple(specs), mesh),
                       dtype=tree.dtype, device="meta")


def local_arguments(cfg: ArchConfig, shape: ShapeConfig, mesh, args,
                    sh) -> Dict:
    """Rank 0's ``meta`` arguments of a step: the parameters' compute
    blocks (``compute_specs``), its block of the batch (and of the cache,
    in the port's layout, and of the token's rows); in training also the
    parameters' and AdamW's blocks of the ZeRO-3 placements the update
    runs on."""
    p, p_sh = args["params"]
    out = {"params": _meta_blocks(p, compute_specs(p_sh, p, mesh, sh),
                                  mesh)}
    rows = batch_shardings(cfg, mesh, shape.global_batch, shape.kind)
    if shape.kind == "train":
        opt, specs = args["opt_state"]
        out["batch"] = _meta_blocks(*args["batch"], mesh)
        out["update"] = (_meta_blocks(p, specs.m, mesh), type(opt)(
            step=opt.step, m=_meta_blocks(opt.m, specs.m, mesh),
            v=_meta_blocks(opt.v, specs.v, mesh)))
    elif shape.kind == "prefill":
        out["batch"] = _meta_blocks(*args["batch"], mesh)
    else:
        out["cache"] = _meta_blocks(*args["cache"], mesh)
        out["token"] = _meta_blocks(args["token"][0],
                                    rows["tokens"][:1], mesh)
    return out


def train_program(cfg: ArchConfig, args, sh, microbatches: int) -> None:
    """Rank 0's program of the sharded train step on its ``meta`` blocks
    (:func:`local_arguments`): per microbatch of its rows the loss
    (``_chunked_xent`` with ``remat``: the forward, and in the backward
    the recompute) and its gradients; then AdamW over the ZeRO-3 blocks,
    the accumulated gradients float32 blocks of them."""
    params = tree_map(lambda t: t.requires_grad_(), args["params"])
    batch = args["batch"]
    rows = next(iter(batch.values())).shape[0] // microbatches
    for i in range(microbatches):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss = _chunked_xent(params, cfg, part, sh, remat=True)
        torch.autograd.grad(loss, leaves(params))
    blocks, state = args["update"]
    grads = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                           device="meta"), state.m)
    AdamW().update(grads, state, blocks)


def run_step(cfg: ArchConfig, shape: ShapeConfig, args, sh,
             microbatches: int, mesh=None):
    """The step once on ``meta`` arguments: (FLOPs, bytes accessed,
    placement records, collective records): rank 0's tensor-parallel
    program on ``mesh`` (its blocks, :func:`local_arguments`)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter, traffic = FlopCounterMode(display=False), _Traffic()
    args = local_arguments(cfg, shape, mesh, args, sh)
    with counter, traffic, recording_placements() as placed, \
            recording_collectives() as moved:
        if shape.kind == "train":
            train_program(cfg, args, sh, microbatches)
        elif shape.kind == "prefill":
            prefill(args["params"], cfg, args["batch"],
                    max_len=shape.seq_len, sh=sh)
        else:
            decode_step(args["params"], cfg, args["cache"], args["token"],
                        sh=sh)
    return counter.get_total_flops(), traffic.bytes, placed, moved


def account(cfg: ArchConfig, shape: ShapeConfig, mesh,
            microbatches: int = 1) -> Dict[str, Any]:
    """Every per-device field of a cell's report on ``mesh``."""
    args = cell_arguments(cfg, shape, mesh)
    seq = shape.seq_len if shape.kind != "decode" else None
    sh = act_sharding(cfg, mesh, shape.global_batch, seq=seq)
    flops, traffic, placed, moved = run_step(cfg, shape, args, sh,
                                             microbatches, mesh)
    activations: Dict[str, int] = {}
    for field, spec, shp, dtype in placed:    # local blocks, as recorded
        n = math.prod(shp) * torch.empty((), dtype=dtype).element_size()
        activations[field] = max(activations.get(field, 0), n)
    return {
        "argument_bytes": argument_bytes(cfg, shape, mesh, args),
        "output_bytes": output_bytes(cfg, shape, mesh, args),
        "temp_bytes": None,
        "flops": flops,
        "bytes_accessed": traffic,
        "flops_raw_costanalysis": None,
        "collective_bytes": collective_bytes(cfg, shape, mesh, args,
                                             microbatches, sh, moved),
        "activations": activations,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell's report, in the JAX report's schema (``compile_s`` is the
    seconds of the accounting, the meta run included)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped", "reason": why}
    chips = math.prod(PRODUCTION_SHAPE[multi_pod][0])
    t0 = time.time()
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        per_device = account(cfg, shape, mesh, microbatches_for(arch))
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "chips": chips,
        "compile_s": round(time.time() - t0, 1),
        "per_device": per_device,
        "params": cfg.n_params(),
        "active_params": cfg.n_active_params(),
        "tokens": shape.tokens if shape.kind != "decode"
        else shape.global_batch,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                try:
                    rep = lower_cell(arch, shape, mp)
                except Exception as e:  # a dry-run failure is a bug
                    rep = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "FAILED", "error": repr(e)[:500]}
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rep, f, indent=2)
                status = rep["status"]
                extra = ""
                if status == "ok":
                    pd = rep["per_device"]
                    extra = (f" args={pd['argument_bytes'] / 2**30:.2f}GiB"
                             f" flops={pd['flops']:.3g}"
                             f" coll={pd['collective_bytes']['total'] / 2**30:.3f}GiB"
                             f" accounting={rep['compile_s']}s")
                print(f"[{status:>7}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")


if __name__ == "__main__":
    main()
