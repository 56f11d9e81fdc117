"""Tensor-parallel serving over ``model`` (``forward``, ``prefill`` and
``decode_step`` with ``ActSharding.mesh``) against the JAX package's
``jax.jit(prefill)`` / ``jax.jit(decode_step)`` under the same placements,
on the CPU: the dense cases.  ``tests/test_torch_tp_parts.py`` holds the
MoE and encoder-decoder cases and the pieces alone.

The JAX package runs on 4 forced host devices, its mesh built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (Auto
axes) under ``jax.set_mesh``, each entry point under ``jit`` with
``--xla_allow_excess_precision=false``, placed as its dry run lowers them
(``repro/launch/dryrun.py``): parameters by ``params_shardings``, the batch
by ``batch_shardings``, the prefill's cache by ``cache_shardings(...,
for_decode=False)``, the decode steps' by ``cache_shardings``, and ``sh =
act_sharding(cfg, mesh, B, seq=...)`` (``seq`` the prompt's length for the
prefill, None for decode).  The port runs on ``gloo`` worlds of 2 and 4
ranks (one process a rank, a ``file://`` store under ``tmp_path``):
parameters carried across with ``params_from_jax`` and placed as
``DTensor``s by the same rules (``launch.sharding.distribute``), each
rank's block of the batch, the prefill's cache narrowed into the decode
layout with ``launch.sharding.narrow_tree``.

The grid: qwen2.5-3b smoke at ``model`` 2 (4 query heads and 2 KV heads,
both split) and 4 (the KV heads replicated, every rank attending with the
one its query head reads; the decode cache's ``head_dim`` sharded), and at
``data`` x ``model`` = 2x2; llama3.2-3b smoke at ``model`` 2 (3 heads: the
prefill sequence-parallel, the decode cache ``head_dim``-sharded); gemma-2b
smoke at ``model`` 2 (1 KV head: the decode cache ``head_dim``-sharded).
A batch of 4 prompts of 16 tokens, then 3 decode steps fed fixed tokens
(so a near-tie cannot make the packages' sequences diverge).

Tolerances: ``tests/test_torch_models.py``'s: the logits to ``LOGIT_TOL``
(rtol = atol = 2.5e-2, about three bf16 ulps at |logit| ~ 1), the caches,
gathered whole, to ``CACHE_TOL`` (2**-5, two bf16 ulps); no wider bound is
needed.  Measured on this grid: the dense cases' logits and caches equal
JAX's bit for bit (the port closes a row-parallel projection with ``psum``
in float32 and rounds once, which is what GSPMD's sum of the bf16 parts
gives at 2 and 4 ranks here), but for llama3.2-3b's caches after the steps
(6.1e-5: the ``head_dim``-sharded scores add their partial sums in another
order than GSPMD); against the port's own unsharded run the logits move by
up to 0.0068, the drift that splitting a bf16 matmul's sum gives on either
package.

Each rank also asserts that its blocks are split: every parameter's local
block has ``local_shape`` of its placement, every cache block (after the
prefill, after the narrowing, after the last step) ``local_shape`` of its
layout, and the activations it recorded (``recording_placements``) are its
``model`` blocks: the query heads a rank computes (H / m where the heads
divide), and the hidden states' sequence (S / m) under sequence
parallelism.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2.5e-2
CACHE_TOL = 2.0**-5
B, S, STEPS = 4, 16, 3
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
CASES = [("qwen2.5-3b", "1x2"), ("qwen2.5-3b", "1x4"),
         ("qwen2.5-3b", "2x2"), ("llama3.2-3b", "1x2"),
         ("gemma-2b", "1x2")]

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
    return "/".join(case)


def inputs(cfg):
    # prompt tokens, frames or patch embeddings, and the decode tokens
    rng = np.random.default_rng(24)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend in ("patch", "frames"):
        out["embeds" if cfg.frontend == "patch" else "frames"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return out, steps


def prompt_len(cfg):
    return S + (cfg.frontend_len if cfg.frontend == "patch" else 0)


def src_len(cfg):
    return cfg.frontend_len if cfg.frontend == "frames" else 0
"""

JAX_SCRIPT = COMMON + r"""
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import get_smoke_config
from repro.launch.sharding import (act_sharding, batch_shardings,
                                   cache_shardings, params_shardings)
import repro.models as jmodels
from repro.models.decode import init_cache

out = {}


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/" + "/".join(str(k.key) for k in path)
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[key + "@bf16"] = a.view(np.uint16)
        else:
            out[key] = a


inits = set()
for arch, mtag in CASES:
    cfg = get_smoke_config(arch)
    data, steps = inputs(cfg)
    shape = MESHES[mtag]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "model"))
    max_len = prompt_len(cfg) + STEPS
    with jax.set_mesh(mesh):
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        if arch not in inits:
            inits.add(arch)
            save_tree(f"init/{arch}", params)
        p_sh = params_shardings(jax.eval_shape(lambda: params), mesh, cfg)
        params = jax.tree_util.tree_map(jax.device_put, params, p_sh)
        batch = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                                else v.dtype) for k, v in data.items()}
        b_sh = batch_shardings(cfg, mesh, B, "prefill")
        acache = jax.eval_shape(lambda: init_cache(cfg, B, max_len,
                                                   src_len(cfg)))
        c_pre = cache_shardings(acache, cfg, mesh, B, for_decode=False)
        c_dec = cache_shardings(acache, cfg, mesh, B)
        sh_p = act_sharding(cfg, mesh, B, seq=prompt_len(cfg))
        sh_d = act_sharding(cfg, mesh, B)
        pre = jax.jit(lambda p, b: jmodels.prefill(p, cfg, b, max_len,
                                                   sh=sh_p),
                      in_shardings=(p_sh, b_sh), out_shardings=(None, c_pre))
        dec = jax.jit(lambda p, c, t: jmodels.decode_step(p, cfg, c, t,
                                                          sh=sh_d),
                      in_shardings=(p_sh, c_dec, None),
                      out_shardings=(None, c_dec))
        logits, cache = pre(params, batch)
        prefix = tag((arch, mtag))
        out[prefix + "/prefill"] = np.asarray(logits)
        save_tree(prefix + "/cache_prefill", cache)
        cache = jax.device_put(cache, c_dec)
        for i in range(STEPS):
            logits, cache = dec(params, cache, jnp.asarray(steps[i]))
            out[f"{prefix}/step{i}"] = np.asarray(logits)
        save_tree(prefix + "/cache", cache)
np.savez(sys.argv[3], **out)
print("RESULT ok")
"""

RANK_SCRIPT = COMMON + r"""
from datetime import timedelta

import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro_torch.configs as tconfigs
from repro_torch.launch.sharding import (act_sharding, batch_shardings,
                                         cache_shardings, distribute,
                                         gather_to, local_block, local_shape,
                                         narrow_tree, params_shardings)
from repro_torch.mesh_axes import all_gather, axis_group, psum
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.decode import init_cache
from repro_torch.models.layers import recording_placements

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


def f32(t):
    return t.detach().to(torch.float32).numpy()


def walk(t, s, path=()):
    if isinstance(t, dict):
        for k in t:
            yield from walk(t[k], s[k], path + (k,))
    else:
        yield path, t, tuple(s)


def check_blocks(blocks, whole, specs, mesh, what):
    # every block has local_shape of its placement: attention caches by
    # KV heads or head_dim, recurrent weights and states by channels (the
    # mLSTM's memory by its key rows)
    for (path, t, spec), (_, w, _) in zip(walk(blocks, specs),
                                         walk(whole, specs)):
        assert tuple(t.shape) == local_shape(tuple(w.shape), spec, mesh), \
            (what, path, tuple(t.shape), tuple(w.shape), spec)


def dump_cache(prefix, cache, specs, mesh):
    for path, t, spec in walk(cache, specs):
        if t.dim() == 0:
            continue
        whole = gather_to(t, spec, (None,) * t.dim(), mesh)
        if rank == 0:
            out[prefix + "/" + "/".join(path)] = f32(whole)


meshes = {}
for arch, mtag in CASES:
    shape = MESHES[mtag]
    if int(np.prod(shape)) != world:
        continue
    if mtag not in meshes:
        meshes[mtag] = init_device_mesh("cpu", shape,
                                        mesh_dim_names=("data", "model"))
    mesh = meshes[mtag]
    cfg = tconfigs.get_smoke_config(arch)
    data, steps = inputs(cfg)
    prefix = tag((arch, mtag))
    whole_p = tree(f"init/{arch}")
    max_len = prompt_len(cfg) + STEPS
    p_specs = params_shardings(whole_p, mesh, cfg)
    params = distribute(whole_p, p_specs, mesh)
    for (path, t, spec) in walk(params, p_specs):
        assert tuple(t.to_local().shape) == local_shape(tuple(t.shape),
                                                        spec, mesh), path
    batch = {k: torch.from_numpy(v).to(torch.bfloat16 if v.dtype ==
                                       np.float32 else torch.int32)
             for k, v in data.items()}
    b_specs = batch_shardings(cfg, mesh, B, "prefill")
    mine = {k: local_block(v, b_specs[k], mesh) for k, v in batch.items()}
    sh_p = act_sharding(cfg, mesh, B, seq=prompt_len(cfg))
    sh_d = act_sharding(cfg, mesh, B)
    whole_c = init_cache(cfg, B, max_len, src_len(cfg), device="meta")
    c_pre = cache_shardings(whole_c, cfg, mesh, B, for_decode=False)
    c_dec = cache_shardings(whole_c, cfg, mesh, B)
    with recording_placements() as placed:
        logits, cache = prefill(params, cfg, mine, max_len, sh=sh_p)
    nmodel = shape[1]
    heads = [shp for f, _, shp, _ in placed if f == "heads"]
    hidden = [shp for f, _, shp, _ in placed if f == "hidden"]
    want_h = cfg.num_heads // nmodel if cfg.num_heads % nmodel == 0 \
        else cfg.num_heads
    attends = any(k in ("attn", "swa") for k in cfg.layer_kinds())
    assert (bool(heads) == attends and all(h[2] == want_h for h in heads)
            ), heads
    seq_par = sh_p.hidden[1] == "model"
    assert all(h[1] == prompt_len(cfg) // (nmodel if seq_par else 1)
               for h in hidden), hidden
    out[f"{prefix}/seq_par/{rank}"] = np.array(seq_par)
    fwd = forward(params, cfg, mine, sh=sh_p)
    check_blocks(cache, whole_c, c_pre, mesh, "prefill cache")
    dump_cache(f"{prefix}/cache_prefill", cache, c_pre, mesh)
    cache = narrow_tree(cache, c_pre, c_dec, mesh)
    check_blocks(cache, whole_c, c_dec, mesh, "decode cache")
    rows = logits.shape[0]
    logits_all = [logits]
    tok_spec = b_specs["tokens"][:1]
    for i in range(STEPS):
        tok = local_block(torch.from_numpy(steps[i]), tok_spec, mesh)
        step, cache = decode_step(params, cfg, cache, tok, sh=sh_d)
        logits_all.append(step)
    check_blocks(cache, whole_c, c_dec, mesh, "cache after the steps")
    dump_cache(f"{prefix}/cache", cache, c_dec, mesh)
    # the batch's rows back whole (over the dp axis), for rank 0
    dp = axis_group(mesh, "data")
    for name, lg in zip(["forward", "prefill"]
                        + [f"step{i}" for i in range(STEPS)],
                        [fwd] + logits_all):
        whole = lg if rows == B else all_gather(lg, dp, 0)
        if rank == 0:
            out[f"{prefix}/{name}"] = whole.numpy()
    if rank == 0:
        # the port's own unsharded run from the same parameters
        out[f"{prefix}/unsharded/forward"] = forward(whole_p, cfg,
                                                     batch).numpy()
        lg, c = prefill(whole_p, cfg, batch, max_len)
        out[f"{prefix}/unsharded/prefill"] = lg.numpy()
        for i in range(STEPS):
            lg, c = decode_step(whole_p, cfg, c, torch.from_numpy(steps[i]))
            out[f"{prefix}/unsharded/step{i}"] = lg.numpy()

EXTRA = CFG.get("EXTRA")
if EXTRA:
    exec(compile(open(EXTRA).read(), EXTRA, "exec"))

np.savez(sys.argv[4], **out)
dist.barrier()
dist.destroy_process_group()
os._exit(0)      # gloo's threads may abort an interpreter's normal exit
"""


def run_all(cmds, timeout=600):
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


def run_grid(work: Path, cases, extra=None):
    """(JAX's arrays, {world: [rank r's arrays]}) for ``cases``; ``extra``
    is a file the ranks run after the cases (more checks of their own)."""
    cfg = json.dumps({"B": B, "S": S, "STEPS": STEPS, "MESHES": MESHES,
                      "CASES": cases, "EXTRA": extra and str(extra)})
    refpath = work / "ref.npz"
    run_all([[sys.executable, "-c", JAX_SCRIPT, str(ROOT), cfg,
              str(refpath)]])
    worlds = sorted({int(np.prod(MESHES[m])) for _, m in cases}
                    | ({2} if extra else set()))
    cmds, outs = [], {}
    for world in worlds:
        outs[world] = [work / f"rank{world}_{r}.npz" for r in range(world)]
        store = work / f"store{world}"
        cmds += [[sys.executable, "-c", RANK_SCRIPT, str(ROOT), cfg,
                  str(refpath), str(outs[world][r]), str(r), str(world),
                  str(store)] for r in range(world)]
    run_all(cmds)
    return dict(np.load(refpath)), {
        w: [dict(np.load(o)) for o in paths] for w, paths in outs.items()}


def f32(arrays, key):
    if key + "@bf16" in arrays:
        bits = arrays[key + "@bf16"].astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.asarray(arrays[key], dtype=np.float32)


def check_case(case, ref, ranks):
    """The gathered logits and caches of one case against JAX's and the
    port's unsharded run (the tolerances of the module docstring)."""
    arch, mtag = case
    prefix = f"{arch}/{mtag}"
    got = ranks[int(np.prod(MESHES[mtag]))][0]
    names = ["prefill"] + [f"step{i}" for i in range(STEPS)]
    for name in names:
        want = ref[f"{prefix}/{name}"]
        assert got[f"{prefix}/{name}"].shape == want.shape, name
        np.testing.assert_allclose(got[f"{prefix}/{name}"], want,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{prefix} {name} vs JAX")
        np.testing.assert_allclose(got[f"{prefix}/{name}"],
                                   got[f"{prefix}/unsharded/{name}"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{prefix} {name} vs unsharded")
    n = 0
    for stage in ("cache_prefill", "cache"):
        for key in sorted(k for k in got if k.startswith(
                f"{prefix}/{stage}/")):
            jkey = key.removesuffix("@bf16")
            want = f32(ref, jkey)
            assert got[key].shape == want.shape, key
            np.testing.assert_allclose(got[key], want, rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=key)
            n += 1
    assert n >= 4, f"{prefix}: {n} cache leaves compared"
    # forward: its last position against the prefill's logits (one
    # partition), every position against the unsharded forward but for
    # an MoE, whose expert-parallel shards drop tokens at their own
    # capacity where the unsharded forward drops at the global one
    fwd = got[f"{prefix}/forward"]
    assert fwd.shape == got[f"{prefix}/unsharded/forward"].shape
    np.testing.assert_allclose(fwd[:, -1], got[f"{prefix}/prefill"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL,
                               err_msg=f"{prefix} forward vs prefill")
    if "moe" not in arch:
        np.testing.assert_allclose(fwd, got[f"{prefix}/unsharded/forward"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{prefix} forward vs unsharded")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_grid(tmp_path_factory.mktemp("tp_serve"), CASES)


@pytest.mark.parametrize("case", CASES, ids="/".join)
def test_tp_serving_matches_jax(case, results):
    """Prefill's last logits, 3 decode steps' logits and the caches after
    the prefill and after the steps, gathered, against the JAX package's
    jitted run under the same placements, and against the port's
    unsharded run; ``forward``'s logits (every position, gathered whole)
    against the prefill's at the last position and the unsharded
    ``forward``'s at every one (``check_case``)."""
    check_case(case, *results)


def test_sequence_parallel_where_heads_do_not_divide(results):
    """llama3.2-3b smoke (3 heads) at ``model`` 2 runs its prefill
    sequence-parallel (each rank recorded hidden states of S / 2 rows:
    asserted on the ranks), and qwen2.5-3b (4 heads) does not."""
    _, ranks = results
    assert all(bool(r["llama3.2-3b/1x2/seq_par/" + str(i)])
               for i, r in enumerate(ranks[2]))
    assert not any(bool(r["qwen2.5-3b/1x2/seq_par/" + str(i)])
                   for i, r in enumerate(ranks[2]))
