"""Set-up: process start to the first timed request (kernel libraries
loaded or built, weights made, inputs parsed, every shape warmed)."""


def read(ctx):
    return ctx.setup_s
