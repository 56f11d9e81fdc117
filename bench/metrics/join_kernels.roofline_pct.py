"""The join kernels' share of their roofline, in percent.

The least time of each launch of ``sorted_probe``, ``bloom_build`` and
``bloom_prune_keys`` in one recorded request (from its operands' shapes,
``harness.roofline``), summed, over the device time the same launches
take in the profiled sub-window: each CUDA kernel's profiled time per
event times the events a request launches.  Nothing when the profile or
the recording holds no join kernel.
"""
from harness import roofline


def read(ctx):
    if ctx.profile is None or not ctx.least:
        return None
    parts = [p for ks in roofline.JOIN_KERNELS.values() for p in ks]
    times = ctx.profile.kernel_times(parts)
    least = device = 0.0
    for wrapper, (launches, least_s) in ctx.least.items():
        for part in roofline.JOIN_KERNELS[wrapper]:
            events, seconds = times[part]
            if events == 0:
                return None
            device += seconds / events * launches
        least += least_s
    return least / device * 100.0 if device > 0 else None
