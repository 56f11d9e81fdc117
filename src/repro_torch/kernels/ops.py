"""Public entry points of the hand-written kernels, and the dispatch policy.

Each wrapper launches its CUDA kernel for CUDA tensors and takes the plain
PyTorch version for CPU tensors; :func:`resolve_use_kernel` decides whether
the join path, the graph algorithms and the LM's self-attention call the
wrappers at all.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import bloom as _bloom
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import frontier as _frontier
from repro_torch.kernels import label_prop as _label_prop
from repro_torch.kernels import segment_csr as _segment_csr
from repro_torch.kernels import sorted_probe as _sorted_probe
from repro_torch.kernels import spmv as _spmv

sorted_probe = _sorted_probe.sorted_probe
join_expand = _sorted_probe.join_expand
bloom_build = _bloom.bloom_build
bloom_probe = _bloom.bloom_probe
# the probe kernel's prune mode: its launches count as bloom_probe's
bloom_prune_keys = _bloom.bloom_prune_keys
segment_counts = _segment_csr.segment_counts
edge_spmv = _spmv.edge_spmv
edge_min_label = _label_prop.edge_min_label
frontier_expand = _frontier.frontier_expand
flash_attention = _flash.flash_attention

WRAPPERS = {"sorted_probe": sorted_probe, "join_expand": join_expand,
            "bloom_build": bloom_build, "bloom_probe": bloom_probe,
            "segment_counts": segment_counts, "edge_spmv": edge_spmv,
            "edge_min_label": edge_min_label,
            "frontier_expand": frontier_expand,
            "flash_attention": flash_attention}


def resolve_use_kernel(use_kernel=None, device=None) -> bool:
    """The one kernel-vs-plain policy: ``None`` auto-picks — the kernels on
    a CUDA device, the plain versions on the CPU (the join path, the graph
    algorithms, and the LM's self-attention).  ``device=None`` means
    the CUDA card when there is one."""
    if use_kernel is not None:
        return bool(use_kernel)
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def bloom_bits_for(build_capacity: int) -> int:
    """Pow-2 Bloom bitset size for a build side of ``build_capacity`` rows.

    ~2 bits per candidate key keeps the false-positive rate useful while the
    bitset stays VMEM-resident; clamped to [256, 16384] so tiny builds don't
    underfill a tile and huge builds don't blow the stationary BlockSpec.
    """
    import math

    raw = 1 << max(8, int(math.ceil(math.log2(max(2 * build_capacity, 1)))))
    return min(raw, 16384)
