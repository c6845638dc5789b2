"""Scenes trained over the whole window (steps x scenes per step)."""


def read(ctx):
    return ctx.scenes / ctx.window_s if ctx.kind == "train" else None
