"""Share of the profiled sub-window in which no operation ran on the
device: 1 - union of device intervals / wall time, in percent."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return (1.0 - p.busy_s / p.window_s) * 100.0
