"""Mean duration of the program's ``vertices`` span a request (it ends in
a device sync), in ms."""


def read(ctx):
    vals = [r["vertices_s"] for r in ctx.done if r["vertices_s"] is not None]
    if not vals:
        return None
    return sum(vals) / len(vals) * 1e3
