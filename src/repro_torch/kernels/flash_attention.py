"""Flash-attention forward (causal / sliding-window GQA): the LM's
self-attention over a whole sequence (``prefill``, ``forward``).

The wrapper of the CUDA kernel ``csrc/flash_attention.cu``, which replaces
the Pallas TPU kernel ``repro/kernels/flash_attention.py::_kernel``.  A CUDA
tensor always launches the kernel (or raises); only a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.  There is no backward: an
input that requires grad raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256


def tensor_map_geometry(t: torch.Tensor):
    """The TMA view of a (B, S, H, Dh) tensor: its dims innermost first,
    (Dh, H, S, B), and the byte strides of H, S and B.  Dh must be
    contiguous and every stride a multiple of 16 bytes (what a tensor map
    takes)."""
    b, s, h, dh = t.shape
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError("flash_attention: head_dim is not contiguous")
    strides = (t.stride(2) * es, t.stride(1) * es, t.stride(0) * es)
    if any(x % 16 for x in strides):
        raise ValueError(f"flash_attention: byte strides {strides} are not "
                         "multiples of 16")
    return (dh, h, s, b), strides


def _check(q, k, v, window, q_offset) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention {name}: shape "
                             f"{tuple(t.shape)}, want (B, S, H, Dh)")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention {name}: not contiguous")
        if t.requires_grad:
            raise ValueError(f"flash_attention {name}: requires grad; the "
                             "kernel has no backward")
        if t.device != q.device:
            raise ValueError(f"flash_attention {name}: on {t.device}, want "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention {name}: dtype {t.dtype}, want "
                            f"{q.dtype}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not floating")
    b, _, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_attention: Hq {hq} is not a multiple of "
                         f"Hkv {hkv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if not 0 <= q_offset < 2**30:
        raise ValueError(f"flash_attention: q_offset {q_offset} is not in "
                         "[0, 2**30)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(Dh)) v`` per query head, reading kv head
    ``h // (Hq // Hkv)``; query row ``i`` is position ``p = i + q_offset``
    and key index ``j`` position ``j`` (``j < Sk``, plus ``p >= j`` when
    ``causal``, plus ``p - j < window``).  ``q_offset`` > 0 is a
    sequence-parallel rank's block of queries against the gathered keys.

    ``q`` (B, Sq, Hq, Dh), ``k``/``v`` (B, Sk, Hkv, Dh), contiguous, one
    dtype; the output has q's shape and dtype.  On the card the inputs must
    be bfloat16 with ``Dh`` a multiple of 8 up to 256.
    """
    q_offset = int(q_offset)
    _check(q, k, v, window, q_offset)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: dtype {q.dtype}; the CUDA kernel "
                        "takes bfloat16")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if dh % 8 != 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {dh} is not a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: not 16-byte aligned")
    if b == 0 or sq == 0 or hq == 0:
        return torch.empty_like(q)
    if sk == 0:                       # no key to attend: the rows are 0
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    qdims, qstrides = tensor_map_geometry(q)
    kdims, kstrides = tensor_map_geometry(k)
    geom = (ctypes.c_int64 * 14)(*qdims, *qstrides, *kdims, *kstrides)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.cast(geom, ctypes.c_void_p),
        ctypes.c_int64(1 if causal else 0),
        ctypes.c_int64(0 if window is None else int(window)),
        ctypes.c_int64(q_offset), ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
