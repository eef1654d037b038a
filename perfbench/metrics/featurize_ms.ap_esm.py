"""Mean host ms to parse one mutation's structure, mutate it and tokenize
the wild type and the mutant (``esm_item``, on the loader's prefetch
thread)."""


def read(ctx):
    return ctx.spans.mean_ms("featurize_item")
