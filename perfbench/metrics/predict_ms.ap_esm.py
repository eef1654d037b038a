"""Mean ms of EsmAffinityModel.predict a batch (one ESM-2 forward and the
head), to the read-back of its predictions."""


def read(ctx):
    return ctx.spans.mean_ms("predict")
