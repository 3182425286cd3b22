"""Faults planted under the timed path, to see ``correct`` come out false:
for the CPU tests and ``calibrate.py``, never in a benchmark run.

A search fault wraps the search that the loop calls (``env`` holds the
adapter, the index, the traffic and the corpus's row count); a build fault
is a context that holds while the index is built.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch


def stale(search, env):
    """Every call returns the first call's answer: a state left unchanged."""
    first = []

    def f(q):
        if not first:
            first.append(search(q))
        return first[0]
    return f


def half(search, env):
    """Half of each batch left out, the other half answered twice."""
    def f(q):
        h = q.shape[0] // 2
        v, r = search(q[:h])
        return torch.cat([v, v]), torch.cat([r, r])
    return f


def altered(search, env):
    """One answer of one batch in the window changed where it is produced."""
    calls = [0]

    def f(q):
        v, r = search(q)
        calls[0] += 1
        if calls[0] == 5:
            r = r.clone()
            r[3, 0] = (r[3, 0] + 1) % env.rows
        return v, r
    return f


def two_probes(search, env):
    """The search scans only the two lists nearest each query, not the
    cell's nprobe."""
    return env.adapter.searcher(env.ix, env.traffic["k"], 2)


@contextmanager
def no_lloyd():
    """The program's k-means returns its k-means++ seeds: no Lloyd iteration."""
    from pyrope_tpu_torch.index import ivf_flat, ivf_pq
    from pyrope_tpu_torch.ops import kmeans

    mods = (ivf_flat, ivf_pq)
    saved = [m.kmeans_build for m in mods]
    for m in mods:
        m.kmeans_build = functools.partial(kmeans.kmeans_build, iters=0)
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.kmeans_build = f


SEARCH = {"stale": stale, "half": half, "altered": altered, "two_probes": two_probes}
BUILD = {"no_lloyd": no_lloyd}
NAMES = tuple(SEARCH) + tuple(BUILD)
