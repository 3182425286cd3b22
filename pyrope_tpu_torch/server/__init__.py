"""Data plane (RESP) + control plane (HTTP) servers: the port's copy of
``pyrope_tpu/server``.

Rebuild of the reference's Garnet-hosted command set and ASP.NET control
plane (SURVEY §2.2, §2.5) as one asyncio process serving both protocols
(``python -m pyrope_tpu_torch.server``).
"""
