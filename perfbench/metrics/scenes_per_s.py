"""Scenes completed over the whole window, offline inference."""


def read(ctx):
    return ctx.scenes / ctx.window_s if ctx.kind == "closed" else None
