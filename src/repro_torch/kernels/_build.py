"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, under
``build/kernels/`` at the repository root (listed in ``.gitignore``), and
is loaded with :mod:`ctypes`.  The library name carries a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.

There is no fallback: without ``nvcc``, or when a build fails, loading
raises, and a kernel wrapper called on a CUDA tensor raises with it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream as c_void_p, every length as
# c_int64; each entry returns its cudaError_t as an int.
_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "sorted_probe": {
        "repro_sorted_probe": (_P, _P, _P, _P, _I, _I, _P),
    },
    "bloom": {
        "repro_bloom_build": (_P, _P, _P, _P, _I, _I, _I, _P),
        "repro_bloom_probe": (_P, _P, _P, _I, _I, _I, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


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


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a launch."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
