"""Share of the traced window in which no kernel or copy ran on the card
(device trace)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
