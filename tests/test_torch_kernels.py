"""The port's kernels: plain versions against the JAX package, exactly.

Inputs are made with numpy from a seed and fed to ``repro`` (Pallas kernels
in interpret mode, and ``repro.kernels.ref``) and to ``repro_torch`` on the
CPU, where the wrappers take their plain PyTorch versions.  Outputs are
integers or bools, so every comparison is exact (tolerance 0).  The CUDA
kernels are held against the plain versions on a card by the jax-free
``tests/test_torch_cuda.py``.
"""
import os
import re
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
from repro_torch.kernels import _build
from repro_torch.kernels import bloom as tbloom
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sorted_probe as tprobe

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


FENCE = tprobe.MAX_FENCE


@pytest.mark.parametrize("n_sorted", [1, 7, FENCE - 1, FENCE, FENCE + 1,
                                      2 * FENCE + 1, 100_000, 2_880_000,
                                      2**22 + 5, 2**31 - 1])
def test_fence_stride_is_the_least_that_fits(n_sorted):
    """The CUDA probe's fence, ``sorted[::stride]``, has at most MAX_FENCE
    keys and covers the build side; a smaller stride would not fit, and a
    build side of at most MAX_FENCE keys is the fence itself."""
    stride = tprobe.fence_stride(n_sorted)
    n_fence = -(-n_sorted // stride)
    assert n_fence <= FENCE and (n_fence - 1) * stride < n_sorted
    assert stride == 1 or -(-n_sorted // (stride - 1)) > FENCE
    assert (stride == 1) == (n_sorted <= FENCE)
    assert len(range(0, n_sorted, stride)) == n_fence


def test_fence_stride_rejects_an_empty_build_side():
    with pytest.raises(ValueError, match="fence"):
        tprobe.fence_stride(0)


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


@pytest.mark.parametrize("n,bits", [(1, 256), (3000, 1024), (5000, 16384),
                                    (777, 1000)])
@pytest.mark.parametrize("num_hashes", [1, 2, 3])
def test_bloom_prune_keys_matches_jax_where(n, bits, num_hashes):
    """The join's pruning in one call: on the CPU exactly the JAX join's
    ``where(bloom_probe(bits, keys), keys, NULL_KEY)`` (Pallas probe in
    interpret mode), with NULL_KEY and negative probe keys."""
    rng = np.random.default_rng(n * 3 + bits + num_hashes)
    build = rng.integers(-5000, 5000, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    probe = np.concatenate([build, rng.integers(-2**31, 2**31 - 1, 2 * n),
                            [NULL32, -1, 0]]).astype(np.int32)
    bits_t = kops.bloom_build(_t(build), _t(valid), bits, num_hashes)
    got = kops.bloom_prune_keys(bits_t, _t(probe), num_hashes)
    assert got.dtype == torch.int32 and tuple(got.shape) == probe.shape
    jbits = jbloom.bloom_build(jnp.asarray(build), jnp.asarray(valid), bits,
                               num_hashes, interpret=True)
    want = jnp.where(jbloom.bloom_probe(jbits, jnp.asarray(probe),
                                        num_hashes, interpret=True),
                     jnp.asarray(probe), NULL32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # no false negatives: a valid build key is never pruned
    assert (got.numpy()[:n][valid] == build[valid]).all()


def test_bloom_prune_keys_prunes_and_keeps_dtype():
    """A sparse filter prunes most foreign keys to NULL_KEY; an empty probe
    side gives an empty int32 result; the CPU path launches nothing."""
    kops.reset_launch_counts()
    bits = kops.bloom_build(_t(np.arange(10, dtype=np.int32)),
                            torch.ones(10, dtype=torch.bool), 16384)
    probe = _t(np.arange(10_000, dtype=np.int32))
    got = kops.bloom_prune_keys(bits, probe).numpy()
    assert (got[:10] == np.arange(10)).all()
    assert (got[10:] == NULL32).mean() > 0.99
    empty = kops.bloom_prune_keys(bits, _t(np.zeros(0, np.int32)))
    assert tuple(empty.shape) == (0,) and empty.dtype == torch.int32
    with pytest.raises(TypeError):
        kops.bloom_prune_keys(bits, probe.to(torch.int64))
    assert kops.launch_counts()["bloom_probe"] == 0


@pytest.mark.parametrize("n_sms", [114, 132])
@pytest.mark.parametrize("n_keys", [1, 40_000, 131_072, 1_800_000, 2_880_000,
                                    4_194_304, 8_388_608, 16_777_216])
def test_bloom_probe_grid_covers_the_keys(n_keys, n_sms):
    """The probe's launch (the path's probe sides): at most
    PROBE_BLOCKS_PER_SM persistent blocks an SM over tiles of
    PROBE_TILE_KEYS (the kernel's threads x 4 vectors of 4 keys), none
    without a tile, which its C entry checks; the entry's arity is the
    one in _build.SIGNATURES."""
    blocks, _ = _build.scatter_grid(n_keys, n_sms,
                                    tile=tbloom.PROBE_TILE_KEYS,
                                    per_sm=tbloom.PROBE_BLOCKS_PER_SM)
    tiles = -(-n_keys // tbloom.PROBE_TILE_KEYS)
    assert 1 <= blocks <= min(tiles, n_sms * tbloom.PROBE_BLOCKS_PER_SM)
    text = (_build.CSRC / "bloom.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 text).group(1))
             for name in ("kProbeThreads", "kVec", "kProbeUnroll",
                          "kProbeBlocksPerSm")}
    assert const["kProbeThreads"] * const["kVec"] * const["kProbeUnroll"] \
        == tbloom.PROBE_TILE_KEYS
    assert const["kProbeBlocksPerSm"] == tbloom.PROBE_BLOCKS_PER_SM
    params = re.search(r'extern "C" int repro_bloom_probe\(([^)]*)\)',
                       text).group(1)
    assert "int64_t blocks" in params and "int64_t prune" in params
    assert params.count(",") + 1 == len(
        _build.SIGNATURES["bloom"]["repro_bloom_probe"])


def test_bloom_bits_policy_matches():
    from repro.kernels.ops import bloom_bits_for as jbits

    for cap in (0, 1, 8, 100, 4096, 10**6, 2**24):
        assert kops.bloom_bits_for(cap) == jbits(cap)


def test_bloom_scratch_is_cached_per_device_and_stream():
    """One zeroed scratch per (device, stream): the same key gives the same
    tensor, another stream another one.  The meta device stands in for a
    card here (it allocates no data)."""
    meta = torch.device("meta")
    first = tbloom.build_scratch(meta, 11)
    assert first.shape == (tbloom.SCRATCH_WORDS,)
    assert first.dtype == torch.int32
    assert tbloom.SCRATCH_WORDS == tbloom.MAX_BITS // 32 + 1
    assert tbloom.build_scratch("meta", 11) is first
    other = tbloom.build_scratch(meta, 12)
    assert other is not first
    assert tbloom.build_scratch(meta, 12) is other


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_bloom_scratch_is_refused_for_a_cpu_tensor(device):
    with pytest.raises(ValueError, match="scratch"):
        tbloom.build_scratch(device, 0)


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
    assert kops.launch_counts() == {
        "sorted_probe": 0, "bloom_build": 0, "bloom_probe": 0,
        "segment_counts": 0, "edge_spmv": 0, "edge_min_label": 0,
        "frontier_expand": 0, "flash_attention": 0}


def test_port_imports_no_jax_and_no_reference():
    """Every repro_torch module (the LM's models, configs and flash kernel
    included) imports without jax and without repro."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "need = ['repro_torch.models.decode', 'repro_torch.models.layers',"
        " 'repro_torch.configs.registry', 'repro_torch.configs.qwen2_5_3b',"
        " 'repro_torch.kernels.flash_attention']\n"
        "assert all(n in sys.modules for n in need), need\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 45


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
