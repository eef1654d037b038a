"""Mean host ms a request spends parsing and featurizing its PDB text and
stacking the batch onto the device."""


def read(ctx):
    return ctx.spans.mean_ms("featurize")
