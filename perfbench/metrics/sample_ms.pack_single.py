"""Mean ms of the sampler (TorsionalDiffusion.sample, 30 steps) a
request, to a synchronise."""


def read(ctx):
    return ctx.spans.mean_ms("sample")
