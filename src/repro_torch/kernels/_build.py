"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, under
``build/kernels/`` at the repository root (listed in ``.gitignore``) or
the directory :func:`set_build_dir` names (the persistent compilation
cache, ``repro_torch.core.pipeline.enable_persistent_compilation_cache``),
and is loaded with :mod:`ctypes`.  The library name carries a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.

There is no fallback: without ``nvcc``, or when a build fails, loading
raises, and a kernel wrapper called on a CUDA tensor raises with it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream as c_void_p, every length as
# c_int64; each entry returns its cudaError_t as an int.
_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "sorted_probe": {
        "repro_sorted_probe": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
        "repro_join_expand": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _P),
    },
    "bloom": {
        "repro_bloom_build": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "repro_bloom_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "segment_csr": {
        "repro_segment_counts": (_P, _P, _P, _I, _I, _I, _P),
    },
    "spmv": {
        "repro_edge_spmv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "label_prop": {
        "repro_edge_min_label": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P),
    },
    "frontier": {
        "repro_frontier_expand": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P),
    },
    "flash_attention": {
        "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# guards the wrappers' launch counters (``fn.launches``): the serving layer
# launches from several threads at once
_COUNT_LOCK = threading.Lock()


def set_build_dir(path) -> None:
    """Build and load the libraries not yet loaded in ``path``."""
    global BUILD_DIR
    with _LOCK:
        BUILD_DIR = Path(path)


def count_launch(fn) -> None:
    """Add one to wrapper ``fn``'s launch counter (thread-safe)."""
    with _COUNT_LOCK:
        fn.launches += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built, and a CUDA tensor has no other path")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: Path, target: Path) -> str:
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)      # atomic: no reader sees a partial library
    return out


def _load(name: str, target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        target = _target(name)
        if not target.exists():
            _finish(name, *_start(name))
        return _load(name, target)


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Build every missing library in parallel (one ``nvcc`` per source)
    and load them all; returns each fresh build's compiler output."""
    logs: Dict[str, str] = {}
    with _LOCK:
        pending = {n: _start(n) for n in names
                   if n not in _LIBS and not _target(n).exists()}
        try:
            for n, job in pending.items():
                logs[n] = _finish(n, *job)
        finally:
            for proc, tmp, _ in pending.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                    tmp.unlink(missing_ok=True)
        for n in names:
            if n not in _LIBS:
                _load(n, _target(n))
    return logs


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, ...)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")


def check_input(t, dtype, what: str, device=None) -> None:
    """What a kernel takes: a contiguous 1-D tensor of ``dtype``, on
    ``device`` when one is given.  Raises on anything else."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, want {dtype}")
    if t.ndim != 1:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, want 1-D")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor is not contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, want {device}")


def check_coo(src, dst, valid, what: str) -> None:
    """The COO edge operands of the graph kernels: int32 ``src`` and
    ``dst`` (``-1`` = no edge) and a bool ``valid``, one length, one
    device."""
    import torch

    check_input(src, torch.int32, f"{what} src")
    check_input(dst, torch.int32, f"{what} dst", device=src.device)
    check_input(valid, torch.bool, f"{what} valid", device=src.device)
    if not src.shape == dst.shape == valid.shape:
        raise ValueError(f"{what}: src, dst and valid differ in length")


# Launch geometry of the scatter kernels (csrc/spmv.cu, csrc/label_prop.cu,
# csrc/segment_csr.cu), of the Bloom build (csrc/bloom.cu) and of
# frontier_expand (csrc/frontier.cu): a tile is 512 threads x 4 edges
# (values, keys), and a few persistent blocks run on each SM.  The Bloom
# probe passes its own tile and blocks an SM (kernels/bloom.py).
SCATTER_TILE_EDGES = 2048
SCATTER_BLOCKS_PER_SM = 4


def scatter_grid(n_edges: int, num_sms: int,
                 tile: int = SCATTER_TILE_EDGES,
                 per_sm: int = SCATTER_BLOCKS_PER_SM) -> Tuple[int, int]:
    """(blocks, edges per block) of a persistent launch over ``n_edges``
    edges (values, keys) in tiles of ``tile``: at most ``per_sm`` blocks an
    SM, each over a contiguous range of whole tiles, as even as whole tiles
    allow and none of them empty.

    ``edge_spmv`` and ``edge_min_label`` give each block that range.
    ``segment_counts``, ``bloom_build``, ``bloom_probe`` and
    ``frontier_expand`` take only the block count and stride the tiles over
    it (block b the tiles b, b + blocks, ...): their inputs are
    prefix-compacted, so a range past the valid rows would idle its
    block."""
    if n_edges <= 0 or num_sms <= 0:
        raise ValueError(f"scatter_grid: no grid for {n_edges} edges on "
                         f"{num_sms} SMs")
    tiles = -(-n_edges // tile)
    per_block = -(-tiles // min(tiles, num_sms * per_sm))
    return -(-tiles // per_block), per_block * tile


@functools.lru_cache(maxsize=None)
def num_sms(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (asked once)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a launch
    (the raw handle, without building a ``torch.cuda.Stream`` each call)."""
    import torch

    index = torch.device(device).index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
