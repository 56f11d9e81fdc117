"""The yardstick of rooflines: the card's peaks and each kernel's least work.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its 700 W
limit.  A launch's least time is the larger of its logical bytes over
the HBM bandwidth and its logical operations over the 32-bit integer
rate, with each input read once and each output written once, whatever
the kernel itself reads again.  The byte and operation counts are frozen
copies of the formulas the port's kernel table was reckoned with.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
HASH_OPS = 6            # multiply, add, shift, xor, modulo, or/test

# the port's join kernels: wrapper name -> the CUDA kernels one call
# launches, by a part of their symbol names
JOIN_KERNELS = {
    "sorted_probe": ("gather_fence", "sorted_probe_kernel"),
    "bloom_build": ("bloom_build_kernel",),
    "bloom_prune_keys": ("bloom_probe_kernel",),
}


def least_s(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def sorted_probe_work(n_sorted: int, n_probe: int) -> Tuple[int, int]:
    """The sorted keys and probe keys read once, two int32 bounds written
    a probe key; a bisection's compares."""
    depth = (max(n_sorted, 2) - 1).bit_length() + 1
    return 4 * n_sorted + 12 * n_probe, 2 * depth * n_probe


def bloom_build_work(n: int, live: int, num_bits: int) -> Tuple[int, int]:
    """A flag a slot, a key a valid slot, an int32 a bit; the hashes."""
    return n + 4 * live + 4 * num_bits, 2 * HASH_OPS * live


def bloom_prune_work(n: int, num_bits: int) -> Tuple[int, int]:
    """A key read and an int32 written a key, the bitset read once."""
    return 8 * n + 4 * num_bits, 2 * HASH_OPS * n


@contextlib.contextmanager
def recording(kops):
    """Swap the join kernels' wrappers in ``kops`` (the program's
    ``repro_torch.kernels.ops``) for recorders while the block runs.
    Each call appends ``(wrapper, least seconds)`` to the yielded list,
    from its operands' shapes (and, for the Bloom build, its count of
    valid keys, which syncs), and goes on to the wrapper.  No tensor is
    kept."""
    calls: List[Tuple[str, float]] = []
    saved = {name: getattr(kops, name) for name in JOIN_KERNELS}

    def sorted_probe(sorted_keys, probe_keys, *a, **k):
        calls.append(("sorted_probe", least_s(*sorted_probe_work(
            sorted_keys.shape[0], probe_keys.shape[0]))))
        return saved["sorted_probe"](sorted_keys, probe_keys, *a, **k)

    def bloom_build(keys, valid, num_bits, *a, **k):
        calls.append(("bloom_build", least_s(*bloom_build_work(
            keys.shape[0], int(valid.sum()), int(num_bits)))))
        return saved["bloom_build"](keys, valid, num_bits, *a, **k)

    def bloom_prune_keys(bits, keys, *a, **k):
        calls.append(("bloom_prune_keys", least_s(*bloom_prune_work(
            keys.shape[0], bits.shape[0]))))
        return saved["bloom_prune_keys"](bits, keys, *a, **k)

    swaps = {"sorted_probe": sorted_probe, "bloom_build": bloom_build,
             "bloom_prune_keys": bloom_prune_keys}
    for name, fn in swaps.items():
        setattr(kops, name, fn)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def least_by_wrapper(calls) -> Dict[str, Tuple[int, float]]:
    """{wrapper: (launches, summed least seconds)} of recorded calls."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, s in calls:
        n, total = out.get(name, (0, 0.0))
        out[name] = (n + 1, total + s)
    return out
