"""Mean ms of the proximal refinement (50 Adam steps) a request, to the
read-back of its accept flag."""


def read(ctx):
    return ctx.spans.mean_ms("refine")
