"""Process start to the measured window: imports, the CUDA context, the
kernel library (built in a checkout's first run), the corpus, the build and
the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
