"""LLM prompt templates.

Rebuild of the reference's ``prompts.py``
(ref: src/Pyrope.AISidecar/prompts.py:1-30): goal-oriented cache-policy,
prefetch-prediction, TTL-advice, and canonical-key prompts. Kept as plain
templates; the worker fills and dispatches them only when a Gemini key is
configured (never in this zero-egress environment).
"""

POLICY_PROMPT = """You control the result cache of a multi-tenant vector database.
Goal: maximize cache hit rate while keeping P99 latency under {target_p99_ms} ms.

Current system metrics for tenant "{tenant}":
- queries/sec: {qps:.1f}
- cache miss rate: {miss_rate:.2f}
- P99 latency: {p99_ms:.1f} ms
- CPU utilization: {cpu:.2f}

Reply with JSON only: {{"admission_threshold": <0.0-1.0>, "ttl_seconds": <30-3600>,
"eviction_priority": <0-2>, "reason": "<one sentence>"}}"""

PREFETCH_PREDICTION_PROMPT = """Given this sequence of semantic-cluster accesses for
tenant "{tenant}" index "{index}": {sequence}
Predict the next cluster id the workload will touch. Reply with JSON only:
{{"next_cluster": <int>, "confidence": <0.0-1.0>}}"""

TTL_ADVICE_PROMPT = """Cluster {cluster_id} of index "{index}" is receiving
{writes_per_min} writes/min while serving cached reads with TTL {ttl_seconds} s.
Should the TTL be shortened or entries evicted? Reply with JSON only:
{{"action": "keep"|"shorten"|"evict", "ttl_seconds": <int>}}"""

CANONICAL_KEY_PROMPT = """These two vector-search queries may be semantically
identical paraphrases: A="{query_a}" B="{query_b}".
Reply with JSON only: {{"same_intent": true|false, "confidence": <0.0-1.0>}}"""
