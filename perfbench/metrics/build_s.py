"""Host rows to a searchable index: ``add_batch`` + ``build()`` +
``torch.cuda.synchronize()`` (host clock)."""


def read(ctx):
    return ctx.build_s
