"""Mutations predicted and read back over the window: from its start until
the last batch started in it is read back."""


def read(ctx):
    return ctx.window["items"] / ctx.window["seconds"]
