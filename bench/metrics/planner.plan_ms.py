"""Mean ``Timings.plan_s`` a request (host-only planning), in ms."""


def read(ctx):
    done = ctx.done
    return sum(r["plan_s"] for r in done) / len(done) * 1e3
