"""The port's kernels: plain versions against the JAX package, exactly.

Inputs are made with numpy from a seed and fed to ``repro`` (Pallas kernels
in interpret mode, and ``repro.kernels.ref``) and to ``repro_torch`` on the
CPU, where the wrappers take their plain PyTorch versions.  Outputs are
integers or bools, so every comparison is exact (tolerance 0).  Tests
marked ``cuda`` hold the CUDA kernels against the plain versions on a card
and skip without one.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bloom as jbloom
from repro.kernels import ref as jref
from repro.kernels import sorted_probe as jprobe
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref

NULL32 = np.int32(2**31 - 1)
ROOT = Path(__file__).resolve().parents[1]


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a)).to(device)


def _probe_parity(sk, pk):
    sk = np.asarray(sk, np.int32)
    pk = np.asarray(pk, np.int32)
    lo, hi = kops.sorted_probe(_t(sk), _t(pk))
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    jlo, jhi = jprobe.sorted_probe(jnp.asarray(sk), jnp.asarray(pk),
                                   interpret=True)
    rlo, rhi = jref.sorted_probe(jnp.asarray(sk), jnp.asarray(pk))
    for got, want in ((lo, jlo), (hi, jhi), (lo, rlo), (hi, rhi)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_sorted", [1, 7, 1000, 5000])
@pytest.mark.parametrize("n_probe", [1, 63, 3000])
def test_sorted_probe_shapes(n_sorted, n_probe):
    rng = np.random.default_rng(n_sorted * 31 + n_probe)
    sk = np.sort(rng.integers(0, 500, n_sorted))
    pk = rng.integers(-5, 505, n_probe)
    _probe_parity(sk, pk)


@pytest.mark.parametrize("sk,pk", [
    pytest.param(np.arange(100), np.zeros(0), id="empty-probe"),
    pytest.param(np.zeros(0), [-3, 0, 7], id="empty-build"),
    pytest.param([1, 5, 5, NULL32, NULL32], [NULL32, NULL32, 5, 0],
                 id="null-tail"),
    pytest.param(np.full(16, NULL32), np.full(7, NULL32), id="all-null"),
    pytest.param([10, 20, 20, 30], [-2**31, -1, 9, 31, 2**31 - 2],
                 id="outside-range"),
    pytest.param(np.sort(np.random.default_rng(7).integers(0, 10_000, 6000)),
                 np.random.default_rng(8).integers(-100, 10_100, 2500),
                 id="multi-block"),
])
def test_sorted_probe_edge_cases(sk, pk):
    _probe_parity(sk, pk)


def _bloom_parity(keys, valid, bits, num_hashes=2, probe=None):
    keys = np.asarray(keys, np.int32)
    valid = np.asarray(valid, bool)
    got = kops.bloom_build(_t(keys), _t(valid), bits, num_hashes)
    assert got.dtype == torch.int32 and tuple(got.shape) == (bits,)
    want = jbloom.bloom_build(jnp.asarray(keys), jnp.asarray(valid), bits,
                              num_hashes, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.bloom_build(
            jnp.asarray(keys), jnp.asarray(valid), bits, num_hashes)))
    probe = keys if probe is None else np.asarray(probe, np.int32)
    hits = kops.bloom_probe(got, _t(probe), num_hashes)
    assert hits.dtype == torch.bool
    jhits = jbloom.bloom_probe(want, jnp.asarray(probe), num_hashes,
                               interpret=True)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    # no false negatives: every valid inserted key probes True
    if probe is keys:
        assert hits.numpy()[valid].all()
    return got


@pytest.mark.parametrize("n,bits", [(50, 256), (1000, 512), (4096, 4096),
                                    (5000, 16384)])
@pytest.mark.parametrize("num_hashes", [1, 2, 3])
def test_bloom_shapes(n, bits, num_hashes):
    rng = np.random.default_rng(n + bits)
    keys = rng.integers(0, 10_000, n)
    valid = rng.random(n) < 0.9
    _bloom_parity(keys, valid, bits, num_hashes)


def test_bloom_empty_sides():
    bits = _bloom_parity(np.zeros(0), np.zeros(0, bool), 256,
                         probe=[1, 2, 3])
    assert int(bits.sum()) == 0
    empty = kops.bloom_probe(bits, _t(np.zeros(0, np.int32)))
    assert tuple(empty.shape) == (0,) and empty.dtype == torch.bool


def test_bloom_all_null_build_keys():
    bits = _bloom_parity(np.full(100, NULL32), np.zeros(100, bool), 256)
    assert int(bits.sum()) == 0


def test_bloom_negative_and_outside_keys():
    rng = np.random.default_rng(13)
    keys = rng.integers(-2**31, 2**31 - 1, 3000)
    _bloom_parity(keys, rng.random(3000) < 0.7, 2048,
                  probe=np.concatenate([keys, [-5, 10_001, 2**31 - 2,
                                               NULL32]]))


def test_bloom_bits_policy_matches():
    from repro.kernels.ops import bloom_bits_for as jbits

    for cap in (0, 1, 8, 100, 4096, 10**6, 2**24):
        assert kops.bloom_bits_for(cap) == jbits(cap)


def test_resolve_use_kernel_follows_device():
    assert kops.resolve_use_kernel(None, "cpu") is False
    assert kops.resolve_use_kernel(None, "cuda") is True
    assert kops.resolve_use_kernel(True, "cpu") is True
    assert kops.resolve_use_kernel(False, "cuda") is False


def test_wrappers_reject_bad_inputs():
    k = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        kops.sorted_probe(k.to(torch.int64), k)
    with pytest.raises(ValueError):
        kops.sorted_probe(k, k.reshape(2, 4))
    with pytest.raises(ValueError):
        kops.sorted_probe(k, torch.arange(16, dtype=torch.int32)[::2])
    with pytest.raises(TypeError):
        kops.bloom_build(k, k, 256)
    with pytest.raises(ValueError):
        kops.bloom_build(k, torch.ones(8, dtype=torch.bool), 1 << 20)


def test_cpu_tensors_never_launch():
    kops.reset_launch_counts()
    k = torch.arange(64, dtype=torch.int32)
    kops.sorted_probe(k, k)
    kops.bloom_probe(kops.bloom_build(k, torch.ones(64, dtype=torch.bool),
                                      256), k)
    assert kops.launch_counts() == {"sorted_probe": 0, "bloom_build": 0,
                                    "bloom_probe": 0}


def test_port_imports_no_jax_and_no_reference():
    """Every repro_torch module imports without jax and without repro."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.data import make_dblp, make_tpcds
    from repro_torch.relational import Table

    with pytest.raises(RuntimeError, match="CUDA"):
        make_tpcds(sf=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dblp(scale=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Table.from_arrays(a=np.arange(4, dtype=np.int32))


# -- on the card: CUDA kernels against the plain versions -----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_sorted,n_probe", [(1, 1), (7, 63), (5000, 3000),
                                              (100_000, 2_880_000)])
def test_cuda_sorted_probe_matches_plain(cuda, n_sorted, n_probe):
    rng = np.random.default_rng(n_sorted + n_probe)
    sk = _t(np.sort(rng.integers(-50, n_sorted, n_sorted)).astype(np.int32),
            cuda)
    pk = _t(rng.integers(-100, n_sorted + 100, n_probe).astype(np.int32),
            cuda)
    before = kops.launch_counts()["sorted_probe"]
    lo, hi = kops.sorted_probe(sk, pk)
    rlo, rhi = tref.sorted_probe(sk, pk)
    torch.cuda.synchronize()
    assert kops.launch_counts()["sorted_probe"] == before + 1
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits,num_hashes", [(1, 256, 2), (5000, 1024, 3),
                                               (2_880_000, 16384, 2)])
def test_cuda_bloom_matches_plain(cuda, n, bits, num_hashes):
    rng = np.random.default_rng(n)
    keys = _t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), cuda)
    valid = _t(rng.random(n) < 0.8, cuda)
    got = kops.bloom_build(keys, valid, bits, num_hashes)
    want = tref.bloom_build(keys, valid, bits, num_hashes)
    assert torch.equal(got, want)
    assert torch.equal(kops.bloom_probe(got, keys, num_hashes),
                       tref.bloom_probe(want, keys, num_hashes))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_edge_cases_match_plain(cuda):
    null = torch.full((16,), int(NULL32), dtype=torch.int32, device=cuda)
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    for sk, pk in ((null, null[:7]), (empty, null), (null, empty)):
        got, want = kops.sorted_probe(sk, pk), tref.sorted_probe(sk, pk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    bits = kops.bloom_build(empty, empty.bool(), 256)
    assert int(bits.sum()) == 0
    assert kops.bloom_probe(bits, empty).shape == (0,)
