"""95th percentile, by nearest rank, of every batch completed inside the
measured window: from just before its search call to its hits in host
memory (host clock)."""

from core.stats import nearest_rank


def read(ctx):
    return nearest_rank(ctx.window.latencies_ms(), 95)
