"""Queries of the batches completed inside the measured window, over its
length (host clock)."""


def read(ctx):
    return len(ctx.window.in_window()) * ctx.window.batch / ctx.seconds
