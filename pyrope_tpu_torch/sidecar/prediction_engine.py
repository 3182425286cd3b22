"""Markov next-cluster prefetch predictor.

Rebuild of the reference's ``PredictionEngine``
(ref: src/Pyrope.AISidecar/prediction_engine.py:7-79): per-(tenant,index)
first-order transition counters over cluster-access sequences, pruned to
caps (1000 tenant-index keys / 500 clusters each); a rule is emitted when
the most common next cluster has been seen ≥3 times.
"""

from __future__ import annotations

import threading
from collections import Counter

MAX_KEYS = 1000
MAX_CLUSTERS_PER_KEY = 500
MIN_RULE_COUNT = 3


class PredictionEngine:
    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, index) -> {from_cluster: Counter({to_cluster: n})}
        self._transitions: dict[tuple[str, str], dict[int, Counter]] = {}
        self._last_cluster: dict[tuple[str, str], int] = {}

    def record_access(self, tenant: str, index: str, cluster_id: int) -> None:
        key = (tenant, index)
        with self._lock:
            prev = self._last_cluster.get(key)
            self._last_cluster[key] = cluster_id
            if prev is None or prev == cluster_id:
                return
            trans = self._transitions.get(key)
            if trans is None:
                if len(self._transitions) >= MAX_KEYS:
                    self._transitions.pop(next(iter(self._transitions)))
                trans = self._transitions[key] = {}
            c = trans.get(prev)
            if c is None:
                if len(trans) >= MAX_CLUSTERS_PER_KEY:
                    trans.pop(next(iter(trans)))
                c = trans[prev] = Counter()
            c[cluster_id] += 1

    def record_batch(self, events: list[dict]) -> None:
        for e in sorted(events, key=lambda e: e.get("timestamp", 0.0)):
            self.record_access(e["tenant_id"], e["index_name"], int(e["cluster_id"]))

    def get_rules(self) -> list[dict]:
        """Most-common-next rules with count ≥ 3 (ref :60-79)."""
        out = []
        with self._lock:
            for (tenant, index), trans in self._transitions.items():
                for frm, counter in trans.items():
                    to, n = counter.most_common(1)[0]
                    if n >= MIN_RULE_COUNT:
                        total = sum(counter.values())
                        out.append(
                            {
                                "tenant_id": tenant,
                                "index_name": index,
                                "from_cluster": frm,
                                "to_cluster": to,
                                "confidence": n / total,
                            }
                        )
        return out
