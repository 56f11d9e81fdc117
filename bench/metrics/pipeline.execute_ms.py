"""Mean ``Timings.extract_s`` a request: views and units executed, ending
in a device sync, in ms."""


def read(ctx):
    done = ctx.done
    return sum(r["extract_s"] for r in done) / len(done) * 1e3
