"""Host wall time of one search call until it returns (it only enqueues),
over the measured window's calls (host clock)."""


def read(ctx):
    spans = [e - s for name, s, e in ctx.window.spans if name == "search"]
    return sum(spans) / len(spans) / 1e6 if spans else None
