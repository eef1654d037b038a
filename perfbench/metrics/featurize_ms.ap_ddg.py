"""Mean host ms to parse one mutation's structure and featurize it with its
mutant twin (on the loader's prefetch thread)."""


def read(ctx):
    return ctx.spans.mean_ms("featurize_item")
