"""Device bytes the built index holds: ``torch.cuda.memory_allocated()``
after the build less before ``add_batch``, the harness's own device copy of
the corpus freed first."""


def read(ctx):
    return ctx.index_bytes / 2**20
