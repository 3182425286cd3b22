"""AI sidecar: the warm-path cache-policy controller (the port's copy of
``pyrope_tpu/sidecar``, imports rewritten).

Rebuild of the reference's ``Pyrope.AISidecar`` (SURVEY §2.6): a gRPC
``PolicyService`` that turns per-tenant system metrics into cache policies
via a heuristic engine, a contextual bandit, an optional LLM policy engine
(gated on ``GEMINI_API_KEY``; this environment has no egress, so it stays
structurally complete but disabled), a Markov prefetch predictor, and a
trained-model lifecycle with canary auto-rollback.

The wire contract is real protobuf/gRPC (``policy_service.proto``,
generated ``policy_service_pb2.py``); service/stub plumbing is hand-rolled
with ``grpc.method_handlers_generic_handler`` since the image ships no
grpc_tools codegen plugin. ``policy_service_pb2.py`` is a byte copy of the JAX
package's: one descriptor (file ``policy_service.proto``, package
``pyrope.sidecar``), so both packages share one wire and one process can
import both. Serving runs no device work and imports no torch; only
``semantic_model`` (the engine-side centroid trainer) runs on the card.
"""
