"""Seconds from the harness's first line to the window's start: imports,
data generation, upload, ANALYZE, kernels loaded (built on a checkout's
first run) and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
