"""Mean ms the window waited on the loader for the next batch (items and
stacking not hidden by its prefetch)."""


def read(ctx):
    return ctx.spans.mean_ms("loader_wait")
