"""Device time a batch of the kernels that are not the port's own (no
``__global__`` of its CUDA sources) and not copies: the probe ranking's
product and top-k, and the whole probe route where it runs (device trace)."""

from core.trace import is_copy, kernel_base


def read(ctx):
    s = ctx.trace.time_s(lambda n: not is_copy(n) and kernel_base(n) not in ctx.kernels)
    return s * 1e3 / ctx.trace.batches if s > 0 else None
