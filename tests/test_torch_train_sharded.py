"""The port's sharded train step (``repro_torch.training.sharded``: FSDP/ZeRO
over ``DTensor`` placements) against the JAX package's
``jax.jit(make_train_step(..., sh=act_sharding(...)))``, on the CPU.

The JAX package runs on 4 forced host devices, its mesh built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (Auto
axes) under ``jax.set_mesh`` (``jax.make_mesh`` gives Explicit axes on
jax 0.9, and the vocab-sharded embedding gather then raises).  Its step
runs under ``jit`` with ``--xla_allow_excess_precision=false``: XLA then
keeps every bf16 rounding the program asks for, and the step equals the
op-by-op run (``jax.disable_jit``, the convention of the other parity
tests) to a float32 ulp, where the op-by-op run of a sharded MoE step takes
minutes (its ``shard_map`` compiles every operation on every call).  The
port runs on ``gloo`` worlds of 2 and 4 ranks (one process a rank, a
``file://`` store under ``tmp_path``, a 60 s collective timeout and a
process timeout).  Parameters and optimizer state go across with
``params_from_jax`` / ``state_from_jax`` and ``shard_train_state``.

At ``model`` 2 the port's step computes tensor-parallel, as GSPMD splits
JAX's: each rank its 2 of the 4 query heads, its FFN columns and its 256
of the 512 vocabulary columns (the loss vocab-parallel), the row-parallel
sums closed by ``psum`` (``models.model``'s docstring; recorded per rank
and asserted by ``test_tp_step_computes_at_its_local_widths``).  Both
partitions sum the split contractions in another order than one device,
and for the MoE that flips a near-tied route now and then: at step 3 of
each ``model`` 2 case 1 or 2 of the 128 tokens route otherwise than in the
port's unsharded step from the same state (the ranks record them), while
the port's routes follow JAX's GSPMD step and its values stay within the
tolerances of it at every step.  So a step whose routes differ is held to
JAX's step alone; the first step's routes must agree.

The grid: meshes ``data`` x ``model`` = 2x1, 1x2 and 2x2; qwen2.5-3b and
qwen3-moe-235b-a22b smoke (ZeRO-1 by ``zero_policy``, plus a ZeRO-3 case of
each at 2x2); 1 and 2 microbatches; ``remat``; AdamW; three steps on a
seeded batch of 8 x 16 tokens.  Each step starts both packages from the
same state (JAX's after the step before), so the tolerances of
``tests/test_torch_training.py::test_train_step_matches_jax`` hold for
each step alone: the loss to ``LOSS_TOL``, the moments to ``GRAD_TOL`` (v
to twice that), the new bf16 parameters to a bf16 ulp where the
gradient's sign is certain and elsewhere to 2 lr (a flipped sign) plus
a bf16 ulp of the reference.  Where the two sides' first moments have
opposite signs, the bound is the exact one for two updates 2 lr apart,
each rounded to bf16 on its own: 2 lr + 2^-8 (|got| + |want|) (the
tensor-parallel step flips one embedding entry whose parameter, 3.357e-4,
sits near lr, to 2 lr + 1.29e-6 of JAX's: 1.0017 of the reference's ulp
alone).  After the first step
AdamW moves a parameter by lr x m_hat / sqrt(v_hat), no longer by lr x
sign(g), and that update carries the moments' errors: from the second
step on each parameter is held to a bf16 ulp plus lr times the change of
m_hat / sqrt(v_hat) that the moments' own tolerances allow (to first
order, entry by entry).  The same holds for the
sharded step against the port's unsharded step from the same state.  The
sharded sums round in another order than one device's: each dp rank's
bf16 gradient of its rows is summed in float32.

Direct checks: the gathered sharded gradient equals the unsharded one at
1x2 and 2x2 (``GRAD_TOL``; a factor of ``nmodel``, or a gradient cut at an
exchange, would be far outside it); at 2x1 with 2 microbatches the MoE
routes of every rank and layer equal JAX's (each rank routes its block of
the microbatch's rows, as GSPMD splits them); every rank's local blocks
have ``local_shape``'s shapes, and their bytes are the dry run's
parameter-plus-state part of ``argument_bytes``; AdafactorLite's sharded
step equals its unsharded step; the differentiable collectives of
``mesh_axes`` alone at world 2 against the same function computed whole;
checkpoints across meshes (2x1 -> 2x2 and -> one device) and across the
packages (2x2 -> JAX, JAX -> 2x2), bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b"]
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
B, S, STEPS = 8, 16, 3
LOSS_TOL = 1e-4
GRAD_TOL = 2.0**-5
BF16_ULP = 2.0**-7
FLIP_ROUNDING = 2.0**-8          # bf16's unit roundoff
# routes (a token's experts in one layer) a near tie may flip in a later
# MoE step
MAX_ROUTE_FLIPS = 2
LR = 3e-4                     # AdamW's default, both packages
CKPT_STEP = 3
# (arch, mesh, microbatches, policy): the JAX reference takes the first
# three (its values do not depend on where the parameters are stored)
CASES = [(a, m, mb, None) for a in ARCHS for m in MESHES for mb in (1, 2)] \
    + [("qwen2.5-3b", "2x2", 2, "zero3"),
       ("qwen3-moe-235b-a22b", "2x2", 1, "zero3")]
ROUTES_CASE = ("qwen3-moe-235b-a22b", "2x1", 2)
CKPT_CASE = ("qwen2.5-3b", "2x1", 2, None)        # saved at 2x1
CKPT_2X2_CASE = ("qwen2.5-3b", "2x2", 2, None)    # saved at 2x2
PARTS = {"dense": ["qwen2.5-3b"], "moe": ["qwen3-moe-235b-a22b"]}


def _tag(case):
    arch, mesh, mb, policy = case
    return f"{arch}/{mesh}/mb{mb}" + (f"/{policy}" if policy else "")


def _jtag(case):
    return "/".join(_tag(case).split("/")[:3])


COMMON = r"""
import os, sys
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import json
import numpy as np
CFG = json.loads(sys.argv[2])
B, S, STEPS = CFG["B"], CFG["S"], CFG["STEPS"]
MESHES = {k: tuple(v) for k, v in CFG["MESHES"].items()}
CASES = [tuple(c) for c in CFG["CASES"]]


def tag(case):
    arch, mesh, mb, policy = case
    return f"{arch}/{mesh}/mb{mb}" + (f"/{policy}" if policy else "")


def tokens(vocab):
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
"""

JAX_SCRIPT = COMMON + r"""
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import get_smoke_config
from repro.launch.sharding import act_sharding, params_shardings
import repro.models as jmodels
import repro.models.moe as jmoe
import repro.training.checkpoint as jckpt
from repro.training.optim import AdamW
from repro.training.train_step import TrainStepConfig, make_train_step

out = {}
part = sys.argv[4]


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/" + "/".join(str(k.key) for k in path)
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[key + "@bf16"] = a.view(np.uint16)
        else:
            out[key] = a


def mesh_of(tag_):
    shape = MESHES[tag_]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


ROUTES = {}
_dispatch = jmoe._local_dispatch


def recorded_dispatch(x_me, logits, spec, cap):
    res = _dispatch(x_me, logits, spec, cap)
    _, st, slot, keep, _ = res
    t_me = x_me.shape[0]
    reached = jnp.where(keep, slot // cap, -1)[jnp.argsort(st, stable=True)]
    jax.debug.callback(
        lambda d, m, r: ROUTES.setdefault((int(d), int(m)), []).append(
            np.asarray(r)),
        jax.lax.axis_index("data"), jax.lax.axis_index("model"),
        reached.reshape(t_me, spec.top_k))
    return res


jmoe._local_dispatch = recorded_dispatch
done, inits = set(), set()
for arch, mtag, mb, _ in CASES:
    if (arch, mtag, mb) in done or arch not in CFG["PARTS"][part]:
        continue
    done.add((arch, mtag, mb))
    cfg = get_smoke_config(arch)
    toks = tokens(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    mesh = mesh_of(mtag)
    with jax.set_mesh(mesh):
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        if arch not in inits:
            inits.add(arch)
            save_tree(f"init/{arch}", params)
        p_sh = params_shardings(jax.eval_shape(lambda: params), mesh, cfg)
        sh = act_sharding(cfg, mesh, batch=B, seq=S)
        params = jax.tree_util.tree_map(jax.device_put, params, p_sh)
        if (arch, mtag, mb) == tuple(CFG["ROUTES_CASE"] or ()):
            fwd = jax.jit(lambda p, b: jmodels.forward(p, cfg, b, sh=sh))
            rows = B // mb
            for i in range(mb):
                ROUTES.clear()
                jax.block_until_ready(fwd(params, {
                    "tokens": batch["tokens"][i * rows:(i + 1) * rows]}))
                for (d, m), calls in ROUTES.items():
                    for layer, r in enumerate(calls):
                        out[f"routes/{i}/{d}/{m}/{layer}"] = r
        opt = AdamW()
        state = opt.init(params)
        step = jax.jit(make_train_step(
            cfg, opt, TrainStepConfig(microbatches=mb, remat=True), sh=sh))
        for k in range(1, STEPS + 1):
            params, state, metrics = step(params, state, batch)
            prefix = f"{arch}/{mtag}/mb{mb}/{k}"
            out[prefix + "/loss"] = np.float32(metrics["loss"])
            save_tree(prefix + "/p", params)
            save_tree(prefix + "/m", state.m)
            save_tree(prefix + "/v", state.v)
        if (arch, mtag, mb) == tuple((CFG["CKPT_CASE"] or ())[:3]):
            jckpt.CheckpointManager(CFG["JAX_CKPT"]).save(
                CFG["CKPT_STEP"], {"p": params, "o": state}, blocking=True)
for arch in CFG["SPREAD"]:
    # the first step on one device too: how far the package's own
    # partitions round apart
    if arch not in CFG["PARTS"][part]:
        continue
    cfg = get_smoke_config(arch)
    toks = tokens(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    with jax.set_mesh(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))):
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        opt = AdamW()
        step = jax.jit(make_train_step(
            cfg, opt, TrainStepConfig(microbatches=1, remat=True)))
        _, state, _ = step(params, opt.init(params), batch)
        save_tree(f"spread/{arch}/m", state.m)
np.savez(sys.argv[3], **out)
print("RESULT ok")
"""

RANK_SCRIPT = COMMON + r"""
import gc
import weakref
from datetime import timedelta

import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.launch import dryrun
from repro_torch.launch.sharding import (act_sharding, local_shape,
                                         params_shardings, same_layout,
                                         spec_of)
from repro_torch.mesh_axes import (all_gather, all_to_all, axis_group,
                                   sum_gradients)
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import recording_placements
from repro_torch.models.moe import recording_routes
from repro_torch.training import optim as toptim
from repro_torch.training import sharded as shd
from repro_torch.training import train_step as tts
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.tree import (flatten, flatten_up_to, leaves,
                                      tree_map)

ref = np.load(sys.argv[3])
rank, world, store = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
out = {}


def tree(prefix):
    flat = {}
    for key in ref.files:
        if key.startswith(prefix + "/"):
            a = ref[key]
            name = key[len(prefix) + 1:]
            if name.endswith("@bf16"):
                name = name[:-5]
                t = torch.from_numpy(a.copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            node = flat
            *dirs, leaf = name.split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = t
    return flat


def dump(prefix, t):
    for path, leaf in flatten(t):
        key = prefix + "/" + "/".join(path)
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            out[key + "@bf16"] = leaf.view(torch.int16).numpy().view(
                np.uint16)
        else:
            out[key] = leaf.numpy()


class Capture:
    # an optimizer that keeps the gradients it is given (whole) and
    # changes nothing
    def update(self, grads, state, params):
        self.grads = (shd.whole_tree(grads) if shd.is_sharded(grads)
                      else tree_map(lambda g: g.clone(), grads))
        return params, state


def start(arch, case_tag, k):
    # (params, AdamW state) that step k starts from: JAX's after step k-1
    if k == 1:
        p = tree(f"init/{arch}")
        st = toptim.AdamW().init(p)
        return p, st
    prefix = "/".join(case_tag.split("/")[:3]) + f"/{k - 1}"
    return tree(prefix + "/p"), toptim.AdamWState(
        step=torch.tensor(k - 1, dtype=torch.int32), m=tree(prefix + "/m"),
        v=tree(prefix + "/v"))


meshes = {}


def mesh_of(mtag):
    if mtag not in meshes:
        meshes[mtag] = init_device_mesh("cpu", MESHES[mtag],
                                        mesh_dim_names=("data", "model"))
    return meshes[mtag]


ckpt_a, ckpt_b, jax_ckpt = CFG["CKPT_A"], CFG["CKPT_B"], CFG["JAX_CKPT"]
for case in CASES:
    arch, mtag, mb, policy = case
    if int(np.prod(MESHES[mtag])) != world:
        continue
    cfg = tconfigs.get_smoke_config(arch)
    mesh = mesh_of(mtag)
    ts = tts.TrainStepConfig(microbatches=mb, remat=True)
    sh = act_sharding(cfg, mesh, batch=B, seq=S)
    toks = tokens(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    opt = toptim.AdamW()
    step = tts.make_train_step(cfg, opt, ts, sh=sh)
    for k in range(1, STEPS + 1):
        p0, s0 = start(arch, tag(case), k)
        pd, sd = shd.shard_train_state(p0, s0, cfg, mesh, policy)
        if k == 1:
            p_specs = params_shardings(p0, mesh, cfg, policy)
            z3 = params_shardings(p0, mesh, cfg, "zero3")
            nbytes = 0
            for (path, t), spec in zip(flatten(pd),
                                       flatten_up_to(p0, p_specs)):
                assert tuple(t.to_local().shape) == local_shape(
                    tuple(t.shape), spec, mesh), path
                nbytes += t.to_local().numel() * t.to_local().element_size()
            for moments in (sd.m, sd.v):
                for (path, t), spec in zip(flatten(moments),
                                           flatten_up_to(p0, z3)):
                    assert tuple(t.to_local().shape) == local_shape(
                        tuple(t.shape), spec, mesh), path
                    assert t.to_local().dtype == torch.float32
                    nbytes += t.to_local().numel() * 4
            nbytes += sd.step.to_local().numel() * 4
            if policy is None:
                args = dryrun.cell_arguments(
                    cfg, ShapeConfig("train", S, B, "train"), mesh)
                want = sum(dryrun.tree_local_bytes(*args[r], mesh)
                           for r in ("params", "opt_state"))
                out[f"bytes/{tag(case)}/{rank}"] = np.array([nbytes, want])
        with recording_routes() as routes, \
                recording_placements() as placed:
            pd, sd, metrics = step(pd, sd, batch)
        assert int(metrics["step"]) == k
        if k == 1:       # the local block of each activation, as computed
            for field, _, shape, _ in placed:
                out.setdefault(f"placed/{tag(case)}/{field}/{rank}",
                               np.array(shape))
        whole_p, whole_s = shd.whole_tree(pd), shd.whole_tree(sd)
        if cfg.moe is not None:
            # every rank's routes of each microbatch's forward, gathered in
            # rank order: the global tokens' order of the microbatch
            per_mb = len(routes) // mb
            mine = torch.stack([routes[i * per_mb + layer]
                                for i in range(mb)
                                for layer in range(cfg.num_layers)])
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine.contiguous())
            tp_routes = torch.cat(parts, dim=1)
        if rank == 0:
            out[f"{tag(case)}/{k}/loss"] = np.float32(metrics["loss"])
            dump(f"{tag(case)}/{k}/p", whole_p)
            dump(f"{tag(case)}/{k}/m", whole_s.m)
            dump(f"{tag(case)}/{k}/v", whole_s.v)
            p0, s0 = start(arch, tag(case), k)
            with recording_routes() as routes_u:
                p0, s0, m_u = tts.make_train_step(cfg, opt, ts)(p0, s0,
                                                                batch)
            if cfg.moe is not None:
                # tokens whose experts differ from the sharded step's
                per_mb = len(routes_u) // mb
                want = torch.stack([routes_u[i * per_mb + layer]
                                    for i in range(mb)
                                    for layer in range(cfg.num_layers)])
                out[f"{tag(case)}/{k}/route_flips"] = np.array(int(
                    (tp_routes.sort(-1).values != want.sort(-1).values)
                    .any(-1).sum()))
            out[f"{tag(case)}/{k}/unsharded/loss"] = np.float32(m_u["loss"])
            dump(f"{tag(case)}/{k}/unsharded/p", p0)
            dump(f"{tag(case)}/{k}/unsharded/m", s0.m)
            dump(f"{tag(case)}/{k}/unsharded/v", s0.v)
        if k == 1 and (arch, mtag, mb) == tuple(CFG["ROUTES_CASE"] or ()):
            per_mb = len(routes) // mb        # forward + remat's recompute
            n_layers = cfg.num_layers
            assert len(routes) == mb * 2 * n_layers
            d = mesh.get_coordinate()[0]
            for i in range(mb):
                for layer in range(n_layers):
                    out[f"routes/{i}/{d}/0/{layer}/{rank}"] = \
                        routes[i * per_mb + layer].numpy()
        if case == tuple(CFG["CKPT_CASE"] or ()) and k == STEPS:
            CheckpointManager(ckpt_a).save(
                CFG["CKPT_STEP"], {"p": pd, "o": sd}, blocking=True)
        if case == tuple(CFG["CKPT_2X2_CASE"] or ()) and k == STEPS:
            CheckpointManager(ckpt_b).save(
                CFG["CKPT_STEP"], {"p": pd, "o": sd}, blocking=True)
            if rank == 0:
                dump("ckpt_b/p", whole_p)
                dump("ckpt_b/o", whole_s)
    if list(case) in CFG["GRAD_CASES"]:
        # the gradients themselves, gathered, against the unsharded step's
        cap = Capture()
        p0, s0 = start(arch, tag(case), 1)
        pd, sd = shd.shard_train_state(p0, s0, cfg, mesh, policy)
        tts.make_train_step(cfg, cap, ts, sh=sh)(pd, sd, batch)
        if rank == 0:
            dump(f"grads/{tag(case)}", cap.grads)
            p0, s0 = start(arch, tag(case), 1)
            tts.make_train_step(cfg, cap, ts)(p0, s0, batch)
            dump(f"grads/{tag(case)}/unsharded", cap.grads)

if world == 2 and CFG["EXTRAS"]:
    # AdafactorLite: one sharded step against its unsharded step, at 2x1
    cfg = tconfigs.get_smoke_config("qwen2.5-3b")
    mesh = mesh_of("2x1")
    toks = tokens(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    fac = toptim.AdafactorLite()
    ts = tts.TrainStepConfig(microbatches=2, remat=True)
    p0 = tree("init/qwen2.5-3b")
    pd, sd = shd.shard_train_state(p0, fac.init(p0), cfg, mesh)
    assert all(spec_of(t) == (None,) * t.ndim for t in leaves(sd.m))
    pd, sd, metrics = tts.make_train_step(
        cfg, fac, ts, sh=act_sharding(cfg, mesh, B, S))(pd, sd, batch)
    whole_p, whole_s = shd.whole_tree(pd), shd.whole_tree(sd)
    if rank == 0:
        out["adafactor/loss"] = np.float32(metrics["loss"])
        dump("adafactor/p", whole_p)
        dump("adafactor/m", whole_s.m)
        p0 = tree("init/qwen2.5-3b")
        p0, s0, m_u = tts.make_train_step(cfg, fac, ts)(p0, fac.init(p0),
                                                        batch)
        out["adafactor/unsharded/loss"] = np.float32(m_u["loss"])
        dump("adafactor/unsharded/p", p0)
        dump("adafactor/unsharded/m", s0.m)

    # init_state builds the state shard by shard: the same leaves,
    # placements and values as shard_train_state of opt.init
    for opt_ in (toptim.AdamW(), toptim.AdafactorLite()):
        p0 = tree("init/qwen2.5-3b")
        pd, sd = shd.shard_train_state(p0, opt_.init(p0), cfg, mesh)
        built = shd.init_state(opt_, pd, cfg)
        pairs = list(zip(flatten(sd), flatten(built)))
        out[f"init_state/{type(opt_).__name__}"] = np.array(
            len(pairs) == len(flatten(sd)) == len(flatten(built)) > 0
            and all(pa == pb and same_layout(spec_of(a), spec_of(b))
                    and a.dtype == b.dtype
                    and torch.equal(a.to_local(), b.to_local())
                    for (pa, a), (pb, b) in pairs))

    # the step's float32 blocks (its gradient accumulators) do not outlive
    # it: with the garbage collector off, a reference cycle would keep them
    made, zeros = [], torch.zeros

    def recording_zeros(*args, **kwargs):
        t = zeros(*args, **kwargs)
        if kwargs.get("dtype") == torch.float32:
            made.append(weakref.ref(t))
        return t

    p0 = tree("init/qwen2.5-3b")
    pd, sd = shd.shard_train_state(p0, toptim.AdamW().init(p0), cfg, mesh)
    step = tts.make_train_step(cfg, toptim.AdamW(), ts,
                               sh=act_sharding(cfg, mesh, B, S))
    gc.disable()
    torch.zeros = recording_zeros
    try:
        step(pd, sd, batch)
    finally:
        torch.zeros = zeros
    out["accumulators_alive"] = np.array(
        [sum(r() is not None for r in made), len(made)])
    gc.enable()

    # the differentiable collectives alone, over the 2 ranks of "data"
    group = axis_group(mesh, "data")
    gen = torch.Generator().manual_seed(7)
    xs = torch.randn(2, 4, 3, generator=gen, dtype=torch.float64)
    cs = torch.randn(2, 4, 3, generator=gen, dtype=torch.float64)
    ws = torch.randn(2, 2, 3, generator=gen, dtype=torch.float64)
    # all_to_all: rank r's loss is sum(c_r * y_r)
    x = xs[rank].clone().requires_grad_()
    (cs[rank] * all_to_all(x, group)).sum().backward()
    out[f"coll/all_to_all/{rank}"] = x.grad.numpy()
    # a weight gathered over the ranks (FSDP): rank r's loss sum(c_r * W)
    w = ws[rank].clone().requires_grad_()
    (cs[rank] * all_gather(w, group, 0)).sum().backward()
    out[f"coll/all_gather_sum/{rank}"] = w.grad.numpy()
    # a replicated input, each rank's slice, gathered for a loss every rank
    # computes alike: sum(c_0 * 3 x**2)
    x = xs[0].clone().requires_grad_()
    mine = sum_gradients(x, group)[rank * 2:(rank + 1) * 2]
    y = all_gather(3 * mine ** 2, group, 0, adjoint="slice")
    (cs[0] * y).sum().backward()
    out[f"coll/all_gather_slice/{rank}"] = x.grad.numpy()

if world == 4 and CFG["EXTRAS"]:
    # checkpoints: the 2x1 save and the JAX package's, restored at 2x2
    cfg = tconfigs.get_smoke_config(CFG["CKPT_CASE"][0])
    mesh = mesh_of("2x2")
    meta = tmodels.init_params(cfg, device="meta")
    like = {"p": meta, "o": toptim.AdamW().init(meta)}
    specs = {"p": params_shardings(meta, mesh, cfg),
             "o": shd.state_specs(meta, mesh, cfg, like["o"])}
    for name, d in (("ckpt_a", ckpt_a), ("ckpt_jax", jax_ckpt)):
        got = CheckpointManager(d).restore(CFG["CKPT_STEP"], like,
                                           mesh=mesh, shardings=specs)
        for path, t in flatten(got):
            spec = specs
            for p_ in path:
                spec = getattr(spec, p_[1:]) if p_.startswith(".") \
                    else spec[p_]
            assert same_layout(spec_of(t), spec), (name, path)
        whole = shd.whole_tree(got)
        if rank == 0:
            dump(name, whole)

EXTRA = CFG.get("EXTRA")
if EXTRA:
    exec(compile(open(EXTRA).read(), EXTRA, "exec"))

np.savez(sys.argv[4], **out)
dist.barrier()
dist.destroy_process_group()
os._exit(0)      # gloo's threads may abort an interpreter's normal exit
"""


def _config(work, cases=CASES, parts=PARTS, steps=STEPS, extras=True,
            extra=None, spread=()):
    """The scripts' configuration: this file's grid by default; another
    file's ``cases`` (with the JAX processes' ``parts``, {name: archs}),
    ``steps``, and an ``extra`` file the ranks run after the cases, without
    this file's ``extras`` (its routes, checkpoints, AdafactorLite and
    collectives); JAX also takes the first step of each arch of ``spread``
    on one device (``spread/<arch>/m``)."""
    return json.dumps({
        "B": B, "S": S, "STEPS": steps, "MESHES": MESHES,
        "CASES": cases, "PARTS": parts, "SPREAD": list(spread),
        "GRAD_CASES": [c for c in cases if MESHES[c[1]][1] == 2
                       and (c[3] is None or not extras)],
        "EXTRAS": extras, "EXTRA": extra and str(extra),
        "ROUTES_CASE": ROUTES_CASE if extras else None,
        "CKPT_CASE": CKPT_CASE if extras else None,
        "CKPT_2X2_CASE": CKPT_2X2_CASE if extras else None,
        "CKPT_STEP": CKPT_STEP,
        "CKPT_A": str(work / "ckpt_a"), "CKPT_B": str(work / "ckpt_b"),
        "JAX_CKPT": str(work / "ckpt_jax")})


def _run_all(cmds, timeout=600):
    """Run the commands together; each must exit 0 within ``timeout``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    errors = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"process {i}: rc {p.returncode}\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)


def run_harness(work, cfg, parts, worlds):
    """(JAX's arrays, {world: [rank r's arrays]}): the JAX processes of
    ``parts`` at once, then each world's ranks."""
    paths = {part: work / f"jax_{part}.npz" for part in parts}
    _run_all([[sys.executable, "-c", JAX_SCRIPT, str(ROOT), cfg, str(path),
               part] for part, path in paths.items()])
    ref = {}
    for path in paths.values():
        ref.update(np.load(path))
    refpath = work / "ref.npz"
    np.savez(refpath, **ref)
    ranks = {}
    for world in worlds:
        outs = [work / f"rank{world}_{r}.npz" for r in range(world)]
        store = work / f"store{world}"
        _run_all([[sys.executable, "-c", RANK_SCRIPT, str(ROOT), cfg,
                   str(refpath), str(outs[r]), str(r), str(world),
                   str(store)] for r in range(world)])
        ranks[world] = [dict(np.load(o)) for o in outs]
    return ref, ranks


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's arrays, {world: [rank r's arrays]}, the work directory)."""
    work = tmp_path_factory.mktemp("train_sharded")
    ref, ranks = run_harness(work, _config(work), PARTS, (2, 4))
    return ref, ranks, work


def _f32(arrays, key):
    if key + "@bf16" in arrays:
        bits = arrays[key + "@bf16"].astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.asarray(arrays[key], dtype=np.float32)


def _keys(arrays, prefix):
    """The leaf keys under ``prefix``, without the bf16 marker."""
    return sorted(k[len(prefix) + 1:].removesuffix("@bf16")
                  for k in arrays if k.startswith(prefix + "/"))


def _close_grad(got, want, tol=GRAD_TOL, key=""):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=key)


def _check_step(got, gp, want, wp, k, scale=1.0):
    """Step ``k``'s loss, moments and parameters: ``got[gp + ...]`` against
    ``want[wp + ...]`` (the tolerances of the module docstring, the
    moments' ``scale`` x ``GRAD_TOL``: ``tests/test_torch_tp_train.py``
    scales them for the recurrent families)."""
    tol = GRAD_TOL * scale
    np.testing.assert_allclose(float(got[gp + "/loss"]),
                               float(want[wp + "/loss"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    keys = _keys(want, wp + "/p")
    assert keys and _keys(got, gp + "/p") == keys
    for key in keys:
        m = _f32(want, f"{wp}/m/{key}")
        v = _f32(want, f"{wp}/v/{key}")
        _close_grad(_f32(got, f"{gp}/m/{key}"), m, tol=tol, key="m/" + key)
        _close_grad(_f32(got, f"{gp}/v/{key}"), v, tol=2 * tol,
                    key="v/" + key)
        g, w = _f32(got, f"{gp}/p/{key}"), _f32(want, f"{wp}/p/{key}")
        if k == 1:
            # the update is lr x sign(g): a bf16 ulp where the sign is
            # certain, 2 lr elsewhere
            sure = np.abs(m) > tol * np.abs(m).max()
            np.testing.assert_allclose(g[sure], w[sure], rtol=BF16_ULP,
                                       atol=0, err_msg="p/" + key)
            flipped = np.sign(_f32(got, f"{gp}/m/{key}")) * np.sign(m) < 0
            np.testing.assert_allclose(g[~flipped], w[~flipped],
                                       rtol=BF16_ULP, atol=2 * LR,
                                       err_msg="p/" + key)
            # where the two sides' moments have opposite signs, the two
            # updates are 2 lr apart and each side is rounded to bf16 on
            # its own: at most half an ulp, 2^-8 of its value, each
            bad = np.abs(g - w)[flipped] > 2 * LR + FLIP_ROUNDING * (
                np.abs(g) + np.abs(w))[flipped]
            assert not bad.any(), (f"p/{key}: {int(bad.sum())} flipped "
                                   f"entries, e.g. {g[flipped][bad][:3]} "
                                   f"against {w[flipped][bad][:3]}")
            continue
        # later the update is lr x m_hat / (sqrt(v_hat) + eps): each entry
        # may be off by what the moments' tolerances allow it (to first
        # order), plus a bf16 ulp
        c1, c2 = 1 - 0.9 ** k, 1 - 0.95 ** k
        dm = tol * (np.abs(m) + np.abs(m).max()) / c1
        dv = 2 * tol * (np.abs(v) + np.abs(v).max()) / c2
        root = np.sqrt(v / c2)
        d_update = dm / (root + 1e-8) + np.abs(m / c1) * dv / (
            2 * np.maximum(root, 1e-30) * (root + 1e-8))
        bad = np.abs(g - w) > BF16_ULP * np.abs(w) + LR * d_update
        assert not bad.any(), (f"p/{key}: {int(bad.sum())} entries, e.g. "
                               f"{g[bad][:3]} against {w[bad][:3]}")


def _rank0(ranks, case):
    return ranks[int(np.prod(MESHES[case[1]]))][0]


@pytest.mark.parametrize("case", CASES, ids=_tag)
def test_sharded_step_matches_jax(case, results):
    """Every step's loss, moments and parameters, gathered whole, against
    the JAX package's sharded step on the same mesh."""
    ref, ranks, _ = results
    got = _rank0(ranks, case)
    for k in range(1, STEPS + 1):
        _check_step(got, f"{_tag(case)}/{k}", ref, f"{_jtag(case)}/{k}", k)


@pytest.mark.parametrize("case", CASES, ids=_tag)
def test_tp_step_computes_at_its_local_widths(case, results):
    """The activations every rank's step computes (``layers.
    recording_placements`` during its first step): at ``model`` 2 the
    attention's 2 of 4 query heads and 256 of the 512 logit columns, at
    ``model`` 1 all of them; the hidden states whole over the sequence
    (the heads divide, so no sequence split) at the rank's rows."""
    _, ranks, _ = results
    world = int(np.prod(MESHES[case[1]]))
    ndp, nmodel = MESHES[case[1]]
    rows = B // case[2] // ndp
    for rank, arrays in enumerate(ranks[world]):
        def placed(field):
            return tuple(arrays[f"placed/{_tag(case)}/{field}/{rank}"])
        assert placed("heads") == (rows, S, 4 // nmodel, 16)
        assert placed("logits") == (rows, S, 512 // nmodel)
        assert placed("hidden") == (rows, S, 64)


@pytest.mark.parametrize("case", CASES, ids=_tag)
def test_sharded_step_matches_unsharded(case, results):
    """Every step against the port's unsharded step from the same state;
    with the loss reported alike on every rank.  A step of the MoE whose
    routes differ from the unsharded step's (a near tie that the
    tensor-parallel sums round across, as GSPMD's do: see the module
    docstring) is held to JAX's step alone (``test_sharded_step_matches_
    jax``); every other step to the unsharded one too.  The first
    step's routes must agree, and in a later step at most
    ``MAX_ROUTE_FLIPS`` routes (a token's experts in one layer) may
    differ (1 or 2 are measured): a routing fault would move many more."""
    _, ranks, _ = results
    got = _rank0(ranks, case)
    checked = 0
    for k in range(1, STEPS + 1):
        flips = got.get(f"{_tag(case)}/{k}/route_flips")
        if flips is not None and int(flips) > 0:
            assert k > 1, f"step 1 routes {int(flips)} tokens otherwise"
            assert int(flips) <= MAX_ROUTE_FLIPS, \
                f"step {k}: {int(flips)} routes differ"
            continue
        _check_step(got, f"{_tag(case)}/{k}", got,
                    f"{_tag(case)}/{k}/unsharded", k)
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("case", [c for c in CASES if c[1] != "2x1"
                                  and c[3] is None], ids=_tag)
def test_sharded_gradients_match_unsharded(case, results):
    """The gradients the sharded step hands the optimizer, gathered whole,
    against the unsharded step's, at ``model`` = 2: a factor of 2, or a
    gradient stopped at an exchange, would be far outside GRAD_TOL."""
    _, ranks, _ = results
    got = _rank0(ranks, case)
    prefix = f"grads/{_tag(case)}"
    keys = _keys(got, prefix + "/unsharded")
    assert keys
    for key in keys:
        want = _f32(got, f"{prefix}/unsharded/{key}")
        assert np.abs(want).max() > 0, key
        _close_grad(_f32(got, f"{prefix}/{key}"), want, key=key)


def test_moe_routes_match_jax_with_two_microbatches(results):
    """At 2x1 with 2 microbatches each rank routes its block of each
    microbatch's rows (GSPMD's split of rows [i mb, (i+1) mb)): every
    rank's and layer's routes, drops included, equal JAX's."""
    ref, ranks, _ = results
    keys = [k for k in ref if k.startswith("routes/")]
    assert len(keys) == 2 * 2 * 2           # microbatches x ranks x layers
    for key in keys:
        i, d, m, layer = key.split("/")[1:]
        got = ranks[2][int(d)][f"{key}/{d}"]
        np.testing.assert_array_equal(np.sort(got, axis=1),
                                      np.sort(ref[key], axis=1),
                                      err_msg=key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_blocks_match_the_dry_run(mesh, results):
    """Every rank's parameter and AdamW blocks have ``local_shape``'s
    shapes (asserted on the ranks), and their bytes, summed over the
    ranks, are the dry run's parameter-plus-state ``argument_bytes`` for
    the mesh times its ranks."""
    _, ranks, _ = results
    world = int(np.prod(MESHES[mesh]))
    for arch in ARCHS:
        for mb in (1, 2):
            tag = _tag((arch, mesh, mb, None))
            got = [r[f"bytes/{tag}/{i}"] for i, r in enumerate(ranks[world])]
            assert sum(int(g[0]) for g in got) == world * int(got[0][1])
            assert all(int(g[0]) == int(g[1]) for g in got), tag


def test_adafactor_sharded_step_matches_unsharded(results):
    """AdafactorLite over shards (its factors whole on every rank, each
    gradient gathered whole): one step at 2x1 equals its unsharded step:
    the loss, the factors to GRAD_TOL (a mean of squares), the new
    parameters to a bf16 ulp plus lr (Adafactor moves each entry by about
    lr)."""
    _, ranks, _ = results
    got = ranks[2][0]
    np.testing.assert_allclose(float(got["adafactor/loss"]),
                               float(got["adafactor/unsharded/loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    lr = 1e-3                 # AdafactorLite's default, both packages
    for key in _keys(got, "adafactor/unsharded/m"):
        _close_grad(_f32(got, f"adafactor/m/{key}"),
                    _f32(got, f"adafactor/unsharded/m/{key}"),
                    tol=2 * GRAD_TOL, key=key)
    keys = _keys(got, "adafactor/unsharded/p")
    assert keys
    for key in keys:
        np.testing.assert_allclose(_f32(got, f"adafactor/p/{key}"),
                                   _f32(got, f"adafactor/unsharded/p/{key}"),
                                   rtol=BF16_ULP, atol=lr, err_msg=key)


def test_step_frees_its_accumulators(results):
    """The sharded step's float32 accumulators (one block of the ZeRO-3
    placement a leaf, about the parameters' size twice over) are freed
    when it returns, with the garbage collector off: no reference cycle
    holds them (on the card one step's would sit beside the next)."""
    _, ranks, _ = results
    for r in ranks[2]:
        alive, made = (int(n) for n in r["accumulators_alive"])
        assert made >= 11 and alive == 0, (alive, made)


@pytest.mark.parametrize("opt", ["AdamW", "AdafactorLite"])
def test_init_state_builds_the_sharded_state(opt, results):
    """``sharded.init_state`` (the optimizer state of ``DTensor``
    parameters, built block by block) gives every rank the leaves,
    placements, dtypes and zeros of ``shard_train_state(opt.init(...))``."""
    _, ranks, _ = results
    assert all(bool(r[f"init_state/{opt}"]) for r in ranks[2])


def test_differentiable_collectives(results):
    """``mesh_axes``' adjoints at world 2 against the same function
    computed whole: ``all_to_all`` (rank r's loss sum(c_r y_r)), a weight
    gathered with ``adjoint="sum"`` (rank r's loss sum(c_r W): the
    gradient of each block sums both ranks' c), and a replicated input
    entered with ``sum_gradients``, sliced, and gathered with
    ``adjoint="slice"`` for a loss every rank computes alike (the gradient
    of the one loss, not twice it)."""
    import torch

    _, ranks, _ = results
    gen = torch.Generator().manual_seed(7)
    xs = torch.randn(2, 4, 3, generator=gen, dtype=torch.float64)
    cs = torch.randn(2, 4, 3, generator=gen, dtype=torch.float64)
    ws = torch.randn(2, 2, 3, generator=gen, dtype=torch.float64)
    # all_to_all: y_r = [x_0 block r, x_1 block r]
    x = xs.clone().requires_grad_()
    ys = [torch.cat([x[0][2 * r:2 * r + 2], x[1][2 * r:2 * r + 2]])
          for r in range(2)]
    sum((cs[r] * ys[r]).sum() for r in range(2)).backward()
    want_a2a = x.grad.numpy()
    w = ws.clone().requires_grad_()
    sum((cs[r] * torch.cat([w[0], w[1]])).sum() for r in range(2)).backward()
    want_ag = w.grad.numpy()
    x0 = xs[0].clone().requires_grad_()
    (cs[0] * 3 * x0 ** 2).sum().backward()
    for r in range(2):
        got = ranks[2][r]
        np.testing.assert_allclose(got[f"coll/all_to_all/{r}"], want_a2a[r],
                                   rtol=1e-12)
        np.testing.assert_allclose(got[f"coll/all_gather_sum/{r}"],
                                   want_ag[r], rtol=1e-12)
        np.testing.assert_allclose(got[f"coll/all_gather_slice/{r}"],
                                   x0.grad.numpy(), rtol=1e-12)


def _same_bytes(got, gp, want, wp):
    keys = _keys(want, wp)
    assert keys and _keys(got, gp) == keys
    for key in keys:
        for suffix in ("", "@bf16"):
            if wp + "/" + key + suffix in want:
                a = got[gp + "/" + key + suffix]
                b = want[wp + "/" + key + suffix]
                assert a.dtype == b.dtype and a.shape == b.shape, key
                assert a.tobytes() == b.tobytes(), key


def test_checkpoint_from_2x1_restores_at_2x2_and_on_one_device(results):
    """The sharded state saved at 2x1 (parameters and AdamW state after
    the last step) restored with ``shardings`` at 2x2, and without on one
    device: every leaf equal, bit for bit."""
    import torch

    import repro_torch.configs as tconfigs
    import repro_torch.models as tmodels
    from repro_torch.training import optim as toptim
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import flatten

    _, ranks, work = results
    saved = _rank0(ranks, CKPT_CASE)
    prefix = f"{_tag(CKPT_CASE)}/{STEPS}"
    got = ranks[4][0]
    _same_bytes(got, "ckpt_a/p", saved, prefix + "/p")
    _same_bytes(got, "ckpt_a/o/.m", saved, prefix + "/m")
    _same_bytes(got, "ckpt_a/o/.v", saved, prefix + "/v")
    assert int(got["ckpt_a/o/.step"]) == STEPS
    cfg = tconfigs.get_smoke_config(CKPT_CASE[0])
    meta = tmodels.init_params(cfg, device="meta")
    one = CheckpointManager(str(work / "ckpt_a")).restore(
        CKPT_STEP, {"p": meta, "o": toptim.AdamW().init(meta)}, "cpu")
    flat = {}
    for path, t in flatten(one):
        t = t.detach()
        key = "/".join(path)
        flat[key + ("@bf16" if t.dtype == torch.bfloat16 else "")] = (
            t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())
    _same_bytes(flat, "p", saved, prefix + "/p")
    _same_bytes(flat, "o/.m", saved, prefix + "/m")
    _same_bytes(flat, "o/.v", saved, prefix + "/v")


def test_checkpoint_from_2x2_restores_in_jax(results):
    """The port's state saved at 2x2 restored by the JAX package's
    ``CheckpointManager.restore`` (whole, one device): every leaf's bytes
    equal the state the port saved."""
    import jax

    import repro.configs as jconfigs
    import repro.models as jmodels
    import repro.training.checkpoint as jckpt
    import repro.training.optim as joptim

    _, ranks, work = results
    saved = _rank0(ranks, CKPT_2X2_CASE)
    cfg = jconfigs.get_smoke_config(CKPT_2X2_CASE[0])
    like = jax.eval_shape(lambda: (lambda p: {
        "p": p, "o": joptim.AdamW().init(p)})(
            jmodels.init_params(cfg, jax.random.PRNGKey(0))))
    got = jckpt.CheckpointManager(str(work / "ckpt_b")).restore(CKPT_STEP,
                                                               like)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(str(getattr(k, "key", None) or "." + k.name)
                       for k in path)
        a = np.asarray(leaf)
        want = saved.get("ckpt_b/" + key, saved.get(f"ckpt_b/{key}@bf16"))
        assert want is not None, key
        assert a.tobytes() == want.tobytes(), key
        n += 1
    assert n == len([k for k in saved if k.startswith("ckpt_b/")])


def test_checkpoint_from_jax_restores_at_2x2(results):
    """The JAX package's state after its last 2x1 step, saved by its
    ``CheckpointManager``, restored by the port with ``shardings`` at 2x2:
    every leaf equal to JAX's, bit for bit."""
    ref, ranks, _ = results
    got = ranks[4][0]
    prefix = f"{_jtag(CKPT_CASE)}/{STEPS}"
    _same_bytes(got, "ckpt_jax/p", ref, prefix + "/p")
    _same_bytes(got, "ckpt_jax/o/.m", ref, prefix + "/m")
    _same_bytes(got, "ckpt_jax/o/.v", ref, prefix + "/v")
    assert int(got["ckpt_jax/o/.step"]) == STEPS
