"""Data plane (RESP) server: the port's copy of ``pyrope_tpu/server``'s
engine, micro-batcher, parser and RESP server and client.

Rebuild of the reference's Garnet-hosted command set (SURVEY §2.2) on
asyncio. The HTTP control plane (``http_api``, ``app``) is not ported yet.
"""
