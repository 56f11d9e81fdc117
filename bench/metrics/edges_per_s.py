"""Valid edge rows returned by the window's completed requests over the
window's wall time: from the loop's start, just before the first
request, to the last request's end, less the seconds that the check's
host copy of the sampled graph took."""


def read(ctx):
    return sum(r["edges"] for r in ctx.done) / ctx.window_s
