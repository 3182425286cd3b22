"""Feature extraction for policy decisions.

Rebuild of the reference's ``feature_engineering.py``
(ref: src/Pyrope.AISidecar/feature_engineering.py:22-114): query features
(vector norm, topK, filter-type encoding), system features, and an LRU
``QueryHistory`` exposing per-key hit rate and revisit interval.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Optional, Sequence


def query_features(
    vector: Sequence[float], top_k: int, filter_tags: Sequence[str] = ()
) -> list[float]:
    norm = math.sqrt(sum(float(x) * float(x) for x in vector)) if vector else 0.0
    # filter-type encoding: 0 none / 1 single tag / 2 multi-tag
    ftype = 0.0 if not filter_tags else (1.0 if len(filter_tags) == 1 else 2.0)
    return [norm, float(top_k), ftype]


def system_features(metrics: dict) -> list[float]:
    return [
        float(metrics.get("qps", 0.0)),
        float(metrics.get("cache_miss_rate", 0.0)),
        float(metrics.get("p99_latency_ms", 0.0)),
        float(metrics.get("cpu_utilization", 0.0)),
    ]


class QueryHistory:
    """LRU history of query-key sightings → hit rate + revisit interval."""

    def __init__(self, capacity: int = 10_000, now=time.time):
        self._cap = capacity
        self._now = now
        self._entries: OrderedDict[str, dict] = OrderedDict()

    def record(self, key: str, was_hit: bool) -> None:
        now = self._now()
        e = self._entries.pop(key, None)
        if e is None:
            e = {"count": 0, "hits": 0, "last_seen": now, "avg_interval": 0.0}
        else:
            interval = now - e["last_seen"]
            n = e["count"]
            e["avg_interval"] = (e["avg_interval"] * (n - 1) + interval) / n if n > 0 else interval
            e["last_seen"] = now
        e["count"] += 1
        e["hits"] += int(was_hit)
        self._entries[key] = e
        if len(self._entries) > self._cap:
            self._entries.popitem(last=False)

    def hit_rate(self, key: str) -> Optional[float]:
        e = self._entries.get(key)
        return None if e is None else e["hits"] / e["count"]

    def revisit_interval(self, key: str) -> Optional[float]:
        e = self._entries.get(key)
        if e is None or e["count"] < 2:
            return None
        return e["avg_interval"]

    def __len__(self) -> int:
        return len(self._entries)
