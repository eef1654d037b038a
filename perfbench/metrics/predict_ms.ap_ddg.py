"""Mean ms of AffinityModel.predict a batch, to the read-back of its
predictions."""


def read(ctx):
    return ctx.spans.mean_ms("predict")
