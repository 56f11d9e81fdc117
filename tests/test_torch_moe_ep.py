"""The port's expert-parallel MoE (``repro_torch.models.moe``'s
``moe_ffn_shard_map``) against the JAX package's, on the CPU.

The JAX package runs on 4 forced host devices; the port on ``gloo``
worlds of 2 and 4 ranks (``file://`` store under ``tmp_path``, 60 s
collective timeout, process timeout), one process a rank.  JAX's
parameters are carried across with ``params_from_jax`` and cut into each
rank's blocks with ``launch.sharding.shard_params``; each rank takes its
block of the tokens (the batch over ``data``).

* ``moe_ffn_shard_map`` at ``data`` x ``model`` = 1x2, 2x2 and, with a
  ``pod`` axis, 1x2x2 (the dp axes ("pod", "data") gathered over a
  flattened sub-mesh), for the qwen3-moe (top-2 of 8) and llama4-scout
  (top-1 of 4, a shared expert) smoke configurations, in float32.  The
  routes of every shard are recorded in both packages (JAX: its own
  ``_local_dispatch`` on the shard's tokens) and must be equal; the
  router's top-k margins of these seeded tokens are asserted above 1e-3,
  so a float32 rounding of the logits (~1e-6 here) cannot flip a choice.
  Output tolerance, as ``tests/test_torch_moe.py``: rtol = 1e-5 and atol
  = 1e-5 x max |output|, a few float32 ulps (the expert products and the
  combine sum in another order; outputs reach O(100) at these widths).
* The reference's other branch (``moe_ffn`` on the whole batch, when the
  tokens do not split over the shards: 6 tokens on 4 shards) against
  JAX's ``moe_ffn`` on the whole batch, same tolerance.
* A whole smoke forward with ``ActSharding(moe_mesh=...)`` at world 2
  (``data`` x ``model`` = 1x2 for both models, 2x1 for llama4-scout) in
  the models' bf16, against JAX's forward with the same ``ActSharding``
  run op by op (``jax.disable_jit``; see ``tests/test_torch_models.py``):
  logits within atol = rtol = 2.5e-2, about three bf16 ulps at |logit| ~ 1
  (the tolerance of the single-device forward tests).  Likewise
  qwen3-moe's ``prefill`` and two ``decode_step``s at 1x2 (each decode
  step's B tokens split over the 2 shards: the expert-parallel path),
  teacher-forced with JAX's argmax tokens.
* ``launch.sharding.placements`` gives ``DTensor`` the same blocks as
  ``shard_params``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
EP_MESHES = {"1x2": ((1, 2), ("data", "model")),
             "2x2": ((2, 2), ("data", "model")),
             "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
WORLD_OF = {"1x2": 2, "2x2": 4, "1x2x2": 4}
FORWARDS = [("qwen3-moe-235b-a22b", "1x2"), ("llama4-scout-17b-a16e", "1x2"),
            ("llama4-scout-17b-a16e", "2x1")]
FWD_MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
TOKENS, FALLBACK_TOKENS = 64, 6
B, S = 2, 20
F32_TOL = 1e-5
LOGIT_TOL = 2.5e-2
MARGIN = 1e-3

COMMON = r"""
import os, sys
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import json
import numpy as np
EP_MESHES = {k: (tuple(v[0]), tuple(v[1]))
             for k, v in json.loads(sys.argv[4]).items()}
FORWARDS = [tuple(f) for f in json.loads(sys.argv[5])]
FWD_MESHES = {k: tuple(v) for k, v in json.loads(sys.argv[6]).items()}
TOKENS, FALLBACK_TOKENS, B, S = (int(a) for a in sys.argv[7:11])
ARCHS = json.loads(sys.argv[11])


def dp_of(names):
    return tuple(a for a in ("pod", "data") if a in names)
"""

JAX_SCRIPT = COMMON + r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import get_smoke_config
from repro.launch.mesh import mesh_context
import repro.models as jmodels
import repro.models.moe as jmoe
from repro.models.model import ActSharding

part = sys.argv[12]
out = {}


def mesh_of(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def save_tree(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/" + "/".join(str(k.key) for k in path)
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[key + "@bf16"] = a.view(np.uint16)
        else:
            out[key] = a


for arch in ARCHS:
    cfg = get_smoke_config(arch)
    spec = cfg.moe
    if part == "ep":
        p = {k: v.astype(jnp.float32) for k, v in
             jmoe.init_moe(jax.random.PRNGKey(0), cfg.d_model, spec).items()}
        save_tree(f"{arch}/p", p)
        x = np.random.default_rng(1).normal(
            size=(TOKENS, cfg.d_model)).astype(np.float32)
        out[f"{arch}/x"] = x
        for tag, (shape, names) in EP_MESHES.items():
            mesh = mesh_of(shape, names)
            dp = dp_of(names)
            with mesh_context(mesh):
                y = jmoe.moe_ffn_shard_map(jnp.asarray(x), p, spec, mesh, dp)
            out[f"{arch}/{tag}/out"] = np.asarray(y)
            nd = int(np.prod([mesh.shape[a] for a in dp]))
            nm = mesh.shape["model"]
            t_local, t_me = TOKENS // nd, TOKENS // (nd * nm)
            cap = max(8, ((int(np.ceil(spec.capacity_factor * t_me
                                       * spec.top_k / spec.num_experts))
                           + 7) // 8) * 8)
            margins = []
            for di in range(nd):
                for mi in range(nm):
                    xm = x[di * t_local + mi * t_me:][:t_me]
                    logits = jnp.asarray(xm) @ p["w_router"]
                    _, st, slot, keep, _ = jmoe._local_dispatch(
                        jnp.asarray(xm), logits, spec, cap)
                    reached = [[] for _ in range(t_me)]
                    for tok, sl, kept in zip(np.asarray(st), np.asarray(slot),
                                             np.asarray(keep)):
                        reached[tok].append(int(sl) // cap if kept else -1)
                    out[f"{arch}/{tag}/routes/{di}/{mi}"] = np.sort(
                        np.array(reached), axis=1)
                    top = np.sort(np.asarray(logits), axis=1)[:, ::-1]
                    margins.append(float((top[:, spec.top_k - 1]
                                          - top[:, spec.top_k]).min()))
            out[f"{arch}/{tag}/margin"] = np.float32(min(margins))
        xf = jnp.asarray(x[:FALLBACK_TOKENS])
        out[f"{arch}/fallback"] = np.asarray(jmoe.moe_ffn(xf, p, spec))
    elif part == "decode":
        if arch != ARCHS[0]:
            continue
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        mesh = mesh_of(FWD_MESHES["1x2"], ("data", "model"))
        sh = ActSharding(moe_mesh=mesh, moe_dp_axes=("data",))
        with mesh_context(mesh), jax.disable_jit():
            logits, cache = jmodels.prefill(
                params, cfg, {"tokens": jnp.asarray(toks)}, max_len=S + 4,
                sh=sh)
            out[f"{arch}/decode/0"] = np.asarray(logits)
            for i in range(1, 3):
                tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
                out[f"{arch}/decode/tok{i}"] = tok
                logits, cache = jmodels.decode_step(
                    params, cfg, cache, jnp.asarray(tok), sh=sh)
                out[f"{arch}/decode/{i}"] = np.asarray(logits)
    else:
        params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        save_tree(f"{arch}/params", params)
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{arch}/tokens"] = toks
        for farch, tag in FORWARDS:
            if farch != arch:
                continue
            mesh = mesh_of(FWD_MESHES[tag], ("data", "model"))
            sh = ActSharding(moe_mesh=mesh, moe_dp_axes=("data",))
            with mesh_context(mesh), jax.disable_jit():
                logits = jmodels.forward(params, cfg,
                                         {"tokens": jnp.asarray(toks)}, sh=sh)
            out[f"{arch}/forward/{tag}"] = np.asarray(logits)
np.savez(sys.argv[3], **out)
print("RESULT ok")
"""

RANK_SCRIPT = COMMON + r"""
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.models.moe as tmoe
from repro_torch.launch.mesh import axis_index
from repro_torch.launch.sharding import (local_block, moe_param_specs,
                                         placements, shard_params)
from repro_torch.models.model import _moe_on_mesh

ref = np.load(sys.argv[2])
rank, world = int(sys.argv[13]), int(sys.argv[14])
dist.init_process_group("gloo", init_method="file://" + sys.argv[15],
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
out = {}


def tree(prefix):
    flat = {}
    for key in ref.files:
        if key.startswith(prefix + "/"):
            a = ref[key]
            name = key[len(prefix) + 1:]
            if name.endswith("@bf16"):
                name, a = name[:-5], a.view(np.uint16)
                t = torch.from_numpy(a.copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            node = flat
            *dirs, leaf = name.split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = t
    return flat


for arch in ARCHS:
    cfg = tconfigs.get_smoke_config(arch)
    spec = cfg.moe
    p = tree(f"{arch}/p")
    x = torch.from_numpy(ref[f"{arch}/x"])
    for tag, (shape, names) in EP_MESHES.items():
        if int(np.prod(shape)) != world:
            continue
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        dp = dp_of(names)
        specs = tmoe.ep_specs(dp)
        specs.update({k: (None,) * p[k].dim() for k in p if k not in specs})
        p_local = shard_params(p, mesh, specs)
        for name in ("w_gate", "w_up", "w_down"):
            dt = distribute_tensor(p[name], mesh,
                                   placements(specs[name], mesh))
            assert torch.equal(dt.to_local(), p_local[name]), (tag, name)
        nd = int(np.prod([mesh.size(names.index(a)) for a in dp]))
        t_local = TOKENS // nd
        di = axis_index(mesh, dp)
        x_local = x[di * t_local:(di + 1) * t_local]
        with tmoe.recording_routes() as routes:
            y = tmoe.moe_ffn_shard_map(x_local, p_local, spec, mesh, dp)
        assert y.shape == x_local.shape and y.dtype == torch.float32
        mi = axis_index(mesh, "model")
        out[f"{arch}/{tag}/out/{di}"] = y.numpy()
        assert len(routes) == 1
        out[f"{arch}/{tag}/routes/{di}/{mi}"] = np.sort(routes[0].numpy(),
                                                        axis=1)
        if tag == "2x2":
            t_fb = FALLBACK_TOKENS // nd
            sh = tmodels.ActSharding(moe_mesh=mesh, moe_dp_axes=dp)
            fb = _moe_on_mesh(x[:FALLBACK_TOKENS][di * t_fb:(di + 1) * t_fb],
                              p_local, cfg, sh)
            out[f"{arch}/fallback/{di}"] = fb.numpy()

for arch, tag in FORWARDS:
    if world != 2:
        continue
    cfg = tconfigs.get_smoke_config(arch)
    params = tree(f"{arch}/params")
    mesh = init_device_mesh("cpu", FWD_MESHES[tag],
                            mesh_dim_names=("data", "model"))
    local = shard_params(params, mesh, moe_param_specs(params, mesh))
    nd = mesh.size(0)
    di = axis_index(mesh, ("data",))
    toks = torch.from_numpy(ref[f"{arch}/tokens"])
    b_local = toks.shape[0] // nd
    sh = tmodels.ActSharding(moe_mesh=mesh, moe_dp_axes=("data",))
    logits = tmodels.forward(local, cfg,
                             {"tokens": toks[di * b_local:(di + 1) * b_local]},
                             sh=sh)
    out[f"{arch}/forward/{tag}/{di}"] = logits.numpy()
    if arch == ARCHS[0] and tag == "1x2":
        logits, cache = tmodels.prefill(local, cfg, {"tokens": toks},
                                        max_len=S + 4, sh=sh)
        out[f"{arch}/decode/0/{rank}"] = logits.numpy()
        for i in range(1, 3):
            tok = torch.from_numpy(ref[f"{arch}/decode/tok{i}"])
            logits, cache = tmodels.decode_step(local, cfg, cache, tok, sh=sh)
            out[f"{arch}/decode/{i}/{rank}"] = logits.numpy()
np.savez(sys.argv[3], **out)
dist.barrier()
dist.destroy_process_group()
os._exit(0)      # gloo's threads may abort an interpreter's normal exit
"""


def _args():
    return [json.dumps(EP_MESHES), json.dumps(FORWARDS),
            json.dumps(FWD_MESHES), str(TOKENS), str(FALLBACK_TOKENS),
            str(B), str(S), json.dumps(ARCHS)]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


def _run_all(cmds, timeout=600):
    """Run the commands together; each must exit 0 within ``timeout``."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env())
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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's arrays, {world: [rank r's arrays]})."""
    work = tmp_path_factory.mktemp("moe_ep")
    parts = {part: work / f"jax_{part}.npz"
             for part in ("ep", "forward", "decode")}
    _run_all([[sys.executable, "-c", JAX_SCRIPT, str(ROOT), "-", str(out),
               *_args(), part] for part, out in parts.items()])
    ref = {}
    for path in parts.values():
        ref.update(np.load(path))
    refpath = work / "ref.npz"
    np.savez(refpath, **ref)
    ranks = {}
    for world in (2, 4):
        outs = [work / f"rank{world}_{r}.npz" for r in range(world)]
        store = work / f"store{world}"
        _run_all([[sys.executable, "-c", RANK_SCRIPT, str(ROOT),
                   str(refpath), str(outs[r]), *_args(), "-", str(r),
                   str(world), str(store)] for r in range(world)])
        ranks[world] = [dict(np.load(o)) for o in outs]
    return ref, ranks


def _close_f32(got, want):
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("tag", list(EP_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_shard_map_matches_jax(arch, tag, results):
    ref, ranks = results
    shape, names = EP_MESHES[tag]
    assert float(ref[f"{arch}/{tag}/margin"]) > MARGIN
    want = ref[f"{arch}/{tag}/out"]
    nd = int(np.prod(shape[:-1]))
    t_local = TOKENS // nd
    seen = set()
    for got in ranks[WORLD_OF[tag]]:
        for key, a in got.items():
            if key.startswith(f"{arch}/{tag}/out/"):
                di = int(key.rsplit("/", 1)[1])
                _close_f32(a, want[di * t_local:(di + 1) * t_local])
            elif key.startswith(f"{arch}/{tag}/routes/"):
                np.testing.assert_array_equal(a, ref[key], err_msg=key)
                seen.add(key)
    assert seen == {k for k in ref if k.startswith(f"{arch}/{tag}/routes/")}


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_that_do_not_split_take_moe_ffn_on_the_whole_batch(arch,
                                                                  results):
    ref, ranks = results
    want = ref[f"{arch}/fallback"]
    t_local = FALLBACK_TOKENS // 2
    for got in ranks[4]:
        for key, a in got.items():
            if key.startswith(f"{arch}/fallback/"):
                di = int(key.rsplit("/", 1)[1])
                _close_f32(a, want[di * t_local:(di + 1) * t_local])


@pytest.mark.parametrize("arch,tag", FORWARDS)
def test_forward_with_moe_mesh_matches_jax(arch, tag, results):
    ref, ranks = results
    want = ref[f"{arch}/forward/{tag}"]
    nd = FWD_MESHES[tag][0]
    b_local = B // nd
    found = 0
    for got in ranks[2]:
        for key, a in got.items():
            if key.startswith(f"{arch}/forward/{tag}/"):
                di = int(key.rsplit("/", 1)[1])
                assert a.dtype == np.float32
                np.testing.assert_allclose(
                    a, want[di * b_local:(di + 1) * b_local],
                    rtol=LOGIT_TOL, atol=LOGIT_TOL)
                found += 1
    assert found == 2


def test_prefill_and_decode_with_moe_mesh_match_jax(results):
    ref, ranks = results
    arch = ARCHS[0]
    for step in range(3):
        want = ref[f"{arch}/decode/{step}"]
        for r, got in enumerate(ranks[2]):
            a = got[f"{arch}/decode/{step}/{r}"]
            assert a.shape == want.shape == (B, a.shape[1])
            np.testing.assert_allclose(a, want, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL,
                                       err_msg=f"step {step} rank {r}")
