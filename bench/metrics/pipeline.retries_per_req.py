"""Overflow retries a request: the change of the engine's
``PipelineCompiler.stats["retries"]`` over each request, averaged."""


def read(ctx):
    done = ctx.done
    return sum(r["retries"] for r in done) / len(done)
