"""Mean host ms a chunk spends parsing and featurizing its PDB texts and
stacking the batch onto the device."""


def read(ctx):
    return ctx.spans.mean_ms("featurize")
