"""The port's hash-partitioned distributed join
(``repro_torch.relational.distributed``) against the JAX package's, on the
CPU.

The same numpy tables (made from a seed) go through both packages: JAX on
2 and 4 forced host devices (``shard_map``), the port on ``gloo`` worlds
of 2 and 4 ranks, each rank fed its block of every table's rows.  Each
runs in its own processes (the JAX reference needs
``--xla_force_host_platform_device_count`` before JAX starts; the ranks
meet through a ``file://`` store under ``tmp_path``, no ports, with a
60 s collective timeout and a process timeout, so a broken collective
fails in seconds).  Every rank's block must equal the JAX shard's block
exactly, in every column and the ``valid`` mask, padding included, and
the overflow counts must be equal.  Tables: uniform keys, skewed keys
(half the rows on one key), NULL keys with invalid rows and padding, a
forced overflow (``cap_factor`` 0.5), and a left side already partitioned
(``left_partitioned=True``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
NL, NR = 512, 768          # divisible by every world size
JOIN_CAPACITY = 1 << 12    # capacity_per_shard
NULL_KEY = 2**31 - 1
CASES = {                  # (cap_factor of the repartitions, joined?)
    "uniform": (2.0, True),
    "skewed": (2.0, True),
    "nulls": (2.0, True),
    "overflow": (0.5, False),
}


def _tables(case: str, rng):
    """(left, right): {column: int32 array} and a valid mask each."""
    lk = rng.integers(0, 64, NL).astype(np.int32)
    rk = rng.integers(0, 64, NR).astype(np.int32)
    lvalid, rvalid = np.ones(NL, bool), np.ones(NR, bool)
    if case == "skewed":
        lk[rng.random(NL) < 0.5] = 3
        rk = rng.integers(-200, 200, NR).astype(np.int32)   # negative keys
    if case == "nulls":
        lk[rng.random(NL) < 0.1] = NULL_KEY
        rk[rng.random(NR) < 0.1] = NULL_KEY
        lvalid = rng.random(NL) > 0.2
        rvalid = rng.random(NR) > 0.2
        lvalid[-40:] = rvalid[-64:] = False           # capacity padding
    left = {"k": lk, "a": np.arange(NL, dtype=np.int32)}
    right = {"k": rk, "b": np.arange(NR, dtype=np.int32) * 3}
    return (left, lvalid), (right, rvalid)


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.launch.mesh import mesh_context
from repro.relational import Table
from repro.relational.distributed import distributed_join, repartition_by_key

inputs = np.load(sys.argv[2])
cases = json.loads(sys.argv[4])
out = {}


def table(prefix, tag):
    cols = {k.split("/")[-1]: jnp.asarray(v) for k, v in inputs.items()
            if k.startswith(tag + "/col/")}
    t = Table(columns=cols, valid=jnp.asarray(inputs[tag + "/valid"]))
    return t.prefix(prefix)


def save(key, t, overflow=None):
    for c, v in t.columns.items():
        out[f"{key}/col/{c}"] = np.asarray(v)
    out[f"{key}/valid"] = np.asarray(t.valid)
    if overflow is not None:
        out[f"{key}/overflow"] = np.asarray(overflow)


for n in [int(sys.argv[6])]:
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    with mesh_context(mesh):
        for case, (cap_factor, joined) in cases.items():
            left = table("L", f"{case}/left")
            right = table("R", f"{case}/right")
            for side, t, col in (("left", left, "L.k"),
                                 ("right", right, "R.k")):
                part, over = repartition_by_key(t, col, mesh,
                                                cap_factor=cap_factor)
                save(f"{n}/{case}/repartition/{side}", part, over)
            if not joined:
                continue
            on = [("L.k", "R.k")]
            save(f"{n}/{case}/join",
                 distributed_join(left, right, on, mesh,
                                  capacity_per_shard=int(sys.argv[5])))
            lpart, _ = repartition_by_key(left, "L.k", mesh)
            save(f"{n}/{case}/join_left_partitioned",
                 distributed_join(lpart, right, on, mesh,
                                  capacity_per_shard=int(sys.argv[5]),
                                  left_partitioned=True))
np.savez(sys.argv[3], **out)
print("RESULT ok")
"""

RANK_SCRIPT = r"""
import os, sys
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import json
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.relational import Table
from repro_torch.relational.distributed import (distributed_join,
                                                repartition_by_key)

inputs = np.load(sys.argv[2])
rank, world = int(sys.argv[4]), int(sys.argv[5])
cases = json.loads(sys.argv[7])
dist.init_process_group("gloo", init_method="file://" + sys.argv[6],
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
out = {}


def block(a):
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def table(prefix, tag):
    cols = {k.split("/")[-1]: block(v) for k, v in inputs.items()
            if k.startswith(tag + "/col/")}
    return Table(columns=cols, valid=block(inputs[tag + "/valid"])
                 ).prefix(prefix)


def save(key, t, overflow=None):
    for c, v in t.columns.items():
        out[f"{key}/col/{c}"] = v.numpy()
    out[f"{key}/valid"] = t.valid.numpy()
    if overflow is not None:
        assert overflow.dtype == torch.int32 and overflow.dim() == 0
        out[f"{key}/overflow"] = overflow.numpy()


for case, (cap_factor, joined) in cases.items():
    left = table("L", f"{case}/left")
    right = table("R", f"{case}/right")
    for side, t, col in (("left", left, "L.k"), ("right", right, "R.k")):
        part, over = repartition_by_key(t, col, mesh, cap_factor=cap_factor)
        save(f"{world}/{case}/repartition/{side}", part, over)
    if not joined:
        continue
    on = [("L.k", "R.k")]
    save(f"{world}/{case}/join",
         distributed_join(left, right, on, mesh,
                          capacity_per_shard=int(sys.argv[8])))
    lpart, _ = repartition_by_key(left, "L.k", mesh)
    save(f"{world}/{case}/join_left_partitioned",
         distributed_join(lpart, right, on, mesh,
                          capacity_per_shard=int(sys.argv[8]),
                          left_partitioned=True))
np.savez(sys.argv[3], **out)
dist.barrier()
dist.destroy_process_group()
os._exit(0)      # gloo's threads may abort an interpreter's normal exit
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    arrays = {}
    for case in CASES:
        for side, (cols, valid) in zip(("left", "right"), _tables(case, rng)):
            for c, v in cols.items():
                arrays[f"{case}/{side}/col/{c}"] = v
            arrays[f"{case}/{side}/valid"] = valid
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def jax_blocks(inputs):
    """The JAX package's results, global arrays (shard i's block is the
    i-th of ``n`` equal slices): one process a world size, run together
    (each ``shard_map`` compiles anew, most of the time)."""
    outs = {n: inputs.with_name(f"jax{n}.npz") for n in WORLDS}
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(ROOT), str(inputs), str(out),
         json.dumps(CASES), str(JOIN_CAPACITY), str(n)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for n, out in outs.items()}
    blocks = {}
    try:
        for n, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "RESULT ok" in stdout, \
                stderr[-3000:]
            blocks.update(np.load(outs[n]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return blocks


def run_ranks(script: str, world: int, workdir: Path, *args) -> list:
    """Start ``world`` rank processes of ``script`` (argv: root, inputs,
    its output, rank, world, the store file, ``args``); wait for all (a
    rank that fails or hangs fails the test within the timeout)."""
    store = workdir / f"store{world}"
    outs = [workdir / f"rank{world}_{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(ROOT), *map(str, args[:1]),
         str(outs[r]), str(r), str(world), str(store), *map(str, args[1:])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            if p.returncode != 0:
                errors.append(f"rank {r}: rc {p.returncode}\n{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def torch_blocks(inputs):
    """{world: [rank r's results]} of the port on gloo."""
    return {w: run_ranks(RANK_SCRIPT, w, inputs.parent, inputs,
                         json.dumps(CASES), JOIN_CAPACITY) for w in WORLDS}


def _check_blocks(jax_blocks, ranks, prefix):
    keys = sorted(k for k in jax_blocks if k.startswith(prefix + "/"))
    assert keys, prefix
    world = len(ranks)
    for key in keys:
        want = jax_blocks[key]
        for r, got in enumerate(ranks):
            assert key in got, (key, r)
            if key.endswith("/overflow"):
                assert int(got[key]) == int(want), (key, r)
                continue
            n = want.shape[0] // world
            block = want[r * n:(r + 1) * n]
            assert got[key].dtype == block.dtype, (key, r)
            np.testing.assert_array_equal(got[key], block,
                                          err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_repartition_by_key_matches_jax(case, world, jax_blocks,
                                        torch_blocks):
    _check_blocks(jax_blocks, torch_blocks[world],
                  f"{world}/{case}/repartition")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c, (_, j) in CASES.items() if j])
def test_distributed_join_matches_jax(case, world, jax_blocks, torch_blocks):
    _check_blocks(jax_blocks, torch_blocks[world], f"{world}/{case}/join")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c, (_, j) in CASES.items() if j])
def test_left_partitioned_join_skips_the_exchange_as_jax(case, world,
                                                         jax_blocks,
                                                         torch_blocks):
    _check_blocks(jax_blocks, torch_blocks[world],
                  f"{world}/{case}/join_left_partitioned")


@pytest.mark.parametrize("world", WORLDS)
def test_cases_do_what_they_claim(world, jax_blocks):
    """The forced-overflow tables drop rows at capacity, and the skewed ones
    at 4 ranks (at 2 the default capacity, twice the fair share, is a
    rank's whole block); the uniform tables drop none; the NULL-key case
    holds valid NULL rows."""
    over = {case: int(jax_blocks[f"{world}/{case}/repartition/left/overflow"])
            for case in CASES}
    assert over["uniform"] == 0 and over["nulls"] == 0
    assert over["overflow"] > 0
    assert (over["skewed"] > 0) == (world == 4)
    valid = jax_blocks[f"{world}/nulls/repartition/left/valid"]
    keys = jax_blocks[f"{world}/nulls/repartition/left/col/L.k"]
    assert (keys[valid] == NULL_KEY).any()


def test_partitioned_results_hold_each_rank_s_keys(torch_blocks):
    """After the exchange a rank holds only valid rows whose key % n is its
    index, and the join holds every match of the single-device join."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.relational import Table, sort_merge_join

    ranks = torch_blocks[4]
    for r, got in enumerate(ranks):
        keys = got["4/uniform/repartition/left/col/L.k"]
        valid = got["4/uniform/repartition/left/valid"]
        assert (np.remainder(keys[valid], 4) == r).all()
    rng = np.random.default_rng(0)
    (lc, lv), (rc, rv) = _tables("uniform", rng)
    left = Table(columns={k: torch.from_numpy(v) for k, v in lc.items()},
                 valid=torch.from_numpy(lv)).prefix("L")
    right = Table(columns={k: torch.from_numpy(v) for k, v in rc.items()},
                  valid=torch.from_numpy(rv)).prefix("R")
    whole = sort_merge_join(left, right, [("L.k", "R.k")])
    cols = ("L.a", "L.k", "R.b", "R.k")
    parts = [Table(columns={c: torch.from_numpy(g[f"4/uniform/join/col/{c}"])
                            for c in cols},
                   valid=torch.from_numpy(g["4/uniform/join/valid"]))
             for g in ranks]
    rows = sorted(row for t in parts for row in zip(
        *(t[c][t.valid].tolist() for c in cols)))
    assert rows == sorted(zip(*(whole[c][whole.valid].tolist()
                                for c in cols)))
