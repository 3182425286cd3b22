"""HTTP control plane (/v1/*): the port's copy of
``pyrope_tpu/server/http_api.py``.

Rebuild of the reference's ASP.NET controllers (SURVEY §2.5) on aiohttp:

- POST /v1/indexes, POST /v1/indexes/{t}/{i}/build|snapshot|load|centroids,
  GET /v1/indexes/{t}/{i}/stats               (ref: Controllers/IndexController.cs)
- POST /v1/tenants, GET/PUT /v1/tenants/{t}/quotas, PUT /{t}/apikey,
  user CRUD + role update                      (ref: Controllers/TenantController.cs)
- GET/PUT /v1/cache/policies, POST /v1/cache/flush|invalidate
                                               (ref: Controllers/CacheController.cs)
- GET /v1/ai/models, POST /v1/ai/models/train|deploy|rollback,
  GET /v1/ai/evaluations — proxied to the sidecar (ref: Controllers/AiController.cs)
- GET /v1/billing/usage                        (ref: Controllers/BillingController.cs)
- GET /v1/audit/logs, /v1/audit/stats          (ref: Controllers/AuditController.cs)
- GET /v1/health, GET /v1/metrics              (ref: Controllers/HealthController.cs)

Auth mirrors ``ApiKeyAuthMiddleware`` + ``RequirePermissionAttribute``
(ref: Security/ApiKeyAuthMiddleware.cs:9-60, RequirePermissionAttribute.cs:
13-60): ``X-API-KEY`` required on /v1/* (health exempt); the admin key acts
as global admin; otherwise the key must resolve to a role on the tenant in
the route with the declared permission.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
from aiohttp import web

from pyrope_tpu_torch.cache import CachePolicyConfig
from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.security import Permission, RbacAuthorizationService, Role
from pyrope_tpu_torch.server.engine import PyropeEngine
from pyrope_tpu_torch.service.tenants import TenantQuota
from pyrope_tpu_torch.types import IndexConfig
from pyrope_tpu_torch.utils.naming import is_valid_name

_API_KEY_HEADER = "X-API-KEY"


def _err(status: int, code: str, message: str) -> web.Response:
    return web.json_response({"error": code, "message": message}, status=status)


async def _json_body(request: web.Request) -> "tuple[dict, Optional[web.Response]]":
    """(body, None) or ({}, 400-response) on malformed/missing JSON."""
    if not request.can_read_body:
        return {}, None
    try:
        body = await request.json()
    except (json.JSONDecodeError, UnicodeDecodeError):
        return {}, _err(400, "VEC_ERR_DIM", "invalid JSON body")
    if not isinstance(body, dict):
        return {}, _err(400, "VEC_ERR_DIM", "JSON object body required")
    return body, None


class HttpApi:
    def __init__(self, engine: PyropeEngine, sidecar_client=None):
        self.engine = engine
        self.rbac = RbacAuthorizationService(engine.tenants, engine.users)
        self.sidecar = sidecar_client  # AiController proxy target; may be None

    # ---- auth helpers ------------------------------------------------------

    def _identity(self, request: web.Request) -> tuple[Optional[str], bool]:
        """(api_key, is_admin)."""
        key = request.headers.get(_API_KEY_HEADER)
        return key, self.engine.authenticator.is_admin_key(key)

    def _authorize(
        self, request: web.Request, permission: Permission, tenant: Optional[str]
    ) -> Optional[web.Response]:
        """None when authorized, else an error response (admin bypasses,
        ref: RequirePermissionAttribute.cs admin bypass)."""
        if not self.engine.authenticator.enabled:
            return None
        key, is_admin = self._identity(request)
        if key is None:
            return _err(401, "VEC_ERR_AUTH", "X-API-KEY header required")
        if is_admin:
            return None
        if permission == Permission.SYSTEM_MANAGE:
            return _err(403, "VEC_ERR_AUTH", "admin key required")
        if tenant is None or not self.rbac.authorize(key, tenant, permission):
            return _err(403, "VEC_ERR_AUTH", "permission denied")
        return None

    def _actor(self, request: web.Request) -> str:
        key, is_admin = self._identity(request)
        if is_admin:
            return "admin"
        if key:
            user = self.engine.users.user_for_api_key(key)
            if user is not None:
                return f"{user.tenant_id}/{user.user_id}"
            owner = self.engine.tenants.tenant_for_api_key(key)
            if owner:
                return owner
        return "anonymous"

    # ---- app wiring ----------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 * 1024 * 1024)
        r = app.router
        r.add_post("/v1/indexes", self.create_index)
        r.add_delete("/v1/indexes/{tenant}/{index}", self.drop_index)
        r.add_post("/v1/indexes/{tenant}/{index}/build", self.build_index)
        r.add_post("/v1/indexes/{tenant}/{index}/snapshot", self.snapshot_index)
        r.add_post("/v1/indexes/{tenant}/{index}/load", self.load_index)
        r.add_get("/v1/indexes/{tenant}/{index}/stats", self.index_stats)
        r.add_post("/v1/indexes/{tenant}/{index}/centroids", self.push_centroids)
        r.add_post("/v1/tenants", self.create_tenant)
        r.add_get("/v1/tenants/{tenant}/quotas", self.get_quotas)
        r.add_put("/v1/tenants/{tenant}/quotas", self.put_quotas)
        r.add_put("/v1/tenants/{tenant}/apikey", self.rotate_apikey)
        r.add_post("/v1/tenants/{tenant}/users", self.create_user)
        r.add_get("/v1/tenants/{tenant}/users", self.list_users)
        r.add_put("/v1/tenants/{tenant}/users/{user}/role", self.update_user_role)
        r.add_delete("/v1/tenants/{tenant}/users/{user}", self.delete_user)
        r.add_get("/v1/cache/policies", self.get_cache_policies)
        r.add_put("/v1/cache/policies", self.put_cache_policies)
        r.add_post("/v1/cache/aliases", self.cache_alias)
        r.add_post("/v1/cache/flush", self.cache_flush)
        r.add_post("/v1/cache/invalidate", self.cache_invalidate)
        r.add_get("/v1/ai/models", self.ai_models)
        r.add_post("/v1/ai/models/train", self.ai_train)
        r.add_post("/v1/ai/models/deploy", self.ai_deploy)
        r.add_post("/v1/ai/models/rollback", self.ai_rollback)
        r.add_get("/v1/ai/evaluations", self.ai_evaluations)
        r.add_get("/v1/billing/usage", self.billing_usage)
        r.add_get("/v1/audit/logs", self.audit_logs)
        r.add_get("/v1/audit/stats", self.audit_stats)
        r.add_post("/v1/debug/trace", self.debug_trace)
        r.add_get("/v1/health", self.health)
        r.add_get("/v1/metrics", self.metrics)
        return app

    # ---- index controller -----------------------------------------------------

    async def create_index(self, request: web.Request) -> web.Response:
        body, bad = await _json_body(request)
        if bad:
            return bad
        tenant = body.get("tenant")
        index = body.get("index")
        if not tenant or not index or not is_valid_name(tenant) or not is_valid_name(index):
            return _err(400, "VEC_ERR_DIM", "tenant/index required ([A-Za-z0-9_-]+)")
        deny = self._authorize(request, Permission.INDEX_CREATE, tenant)
        if deny:
            return deny
        try:
            cfg = IndexConfig.from_dict(body)
        except (KeyError, ValueError) as e:
            return _err(400, "VEC_ERR_DIM", f"bad index config: {e}")
        try:
            self.engine.create_index(tenant, index, cfg)
        except ValueError as e:
            return _err(409, "VEC_ERR_DIM", str(e))
        self.engine.audit.log(tenant, self._actor(request), "index.create",
                              f"{tenant}/{index}", {"config": cfg.to_dict()})
        return web.json_response({"status": "created", "config": cfg.to_dict()}, status=201)

    async def drop_index(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_DELETE, tenant)
        if deny:
            return deny
        if not self.engine.registry.drop(tenant, index):
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        self.engine.index_meta.delete(tenant, index)
        self.engine.store.purge_index(tenant, index)
        self.engine.invalidate_cache(tenant, index)
        self.engine.audit.log(tenant, self._actor(request), "index.delete",
                              f"{tenant}/{index}")
        return web.json_response({"status": "deleted"})

    async def build_index(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_BUILD, tenant)
        if deny:
            return deny
        import asyncio

        ok = await asyncio.to_thread(self.engine.build_index, tenant, index)
        if not ok:
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        self.engine.audit.log(tenant, self._actor(request), "index.build", f"{tenant}/{index}")
        return web.json_response({"status": "built", "stats": self.engine.stats(tenant, index)})

    async def snapshot_index(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_SNAPSHOT, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        path = body.get("path")
        if not path:
            return _err(400, "VEC_ERR_DIM", "path required")
        import asyncio

        try:
            nbytes = await asyncio.to_thread(self.engine.snapshot_index, tenant, index, path)
        except ValueError as e:
            return _err(400, "VEC_ERR_DIM", str(e))
        if nbytes is None:
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        self.engine.audit.log(tenant, self._actor(request), "index.snapshot",
                              f"{tenant}/{index}", {"bytes": nbytes})
        return web.json_response({"status": "snapshotted", "bytes": nbytes})

    async def load_index(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_LOAD, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        path = body.get("path")
        if not path:
            return _err(400, "VEC_ERR_DIM", "path required")
        import asyncio

        try:
            ok = await asyncio.to_thread(self.engine.load_index, tenant, index, path)
        except (ValueError, OSError) as e:
            return _err(400, "VEC_ERR_DIM", str(e))
        if not ok:
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        self.engine.audit.log(tenant, self._actor(request), "index.load", f"{tenant}/{index}")
        return web.json_response({"status": "loaded", "stats": self.engine.stats(tenant, index)})

    async def index_stats(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_READ, tenant)
        if deny:
            return deny
        s = self.engine.stats(tenant, index)
        if s is None:
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        return web.json_response(s)

    async def push_centroids(self, request: web.Request) -> web.Response:
        tenant, index = request.match_info["tenant"], request.match_info["index"]
        deny = self._authorize(request, Permission.INDEX_BUILD, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        cents = body.get("centroids")
        if not isinstance(cents, list) or not cents:
            return _err(400, "VEC_ERR_DIM", "centroids: [[...], ...] required")
        arr = np.asarray(cents, dtype=np.float32)
        if arr.ndim != 2:
            return _err(400, "VEC_ERR_DIM", "centroids must be 2-D")
        if not self.engine.push_centroids(tenant, index, arr):
            return _err(404, "VEC_ERR_NOT_FOUND", "index not found")
        self.engine.audit.log(tenant, self._actor(request), "index.centroids",
                              f"{tenant}/{index}", {"k": int(arr.shape[0])})
        return web.json_response({"status": "updated", "clusters": int(arr.shape[0])})

    # ---- tenant controller -----------------------------------------------------

    async def create_tenant(self, request: web.Request) -> web.Response:
        body, bad = await _json_body(request)
        if bad:
            return bad
        tenant = body.get("tenant")
        if not tenant or not is_valid_name(tenant):
            return _err(400, "VEC_ERR_DIM", "tenant required ([A-Za-z0-9_-]+)")
        # tenant creation is an admin operation (no tenant exists to own it yet)
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        quotas = TenantQuota.from_dict(body.get("quotas") or {})
        try:
            cfg = self.engine.tenants.create(tenant, api_key=body.get("api_key"), quotas=quotas)
        except ValueError as e:
            return _err(409, "VEC_ERR_DIM", str(e))
        self.engine.audit.log(tenant, self._actor(request), "tenant.create", tenant)
        return web.json_response(
            {"tenant": tenant, "api_key": cfg.api_key, "quotas": cfg.quotas.to_dict()},
            status=201,
        )

    async def get_quotas(self, request: web.Request) -> web.Response:
        tenant = request.match_info["tenant"]
        deny = self._authorize(request, Permission.TENANT_READ, tenant)
        if deny:
            return deny
        cfg = self.engine.tenants.try_get(tenant)
        if cfg is None:
            return _err(404, "VEC_ERR_NOT_FOUND", "tenant not found")
        return web.json_response(cfg.quotas.to_dict())

    async def put_quotas(self, request: web.Request) -> web.Response:
        tenant = request.match_info["tenant"]
        deny = self._authorize(request, Permission.TENANT_UPDATE, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        quotas = TenantQuota.from_dict(body)
        if not self.engine.tenants.update_quotas(tenant, quotas):
            return _err(404, "VEC_ERR_NOT_FOUND", "tenant not found")
        self.engine.audit.log(tenant, self._actor(request), "tenant.quotas.update",
                              tenant, {"quotas": quotas.to_dict()})
        return web.json_response(quotas.to_dict())

    async def rotate_apikey(self, request: web.Request) -> web.Response:
        tenant = request.match_info["tenant"]
        deny = self._authorize(request, Permission.TENANT_UPDATE, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        try:
            new_key = self.engine.tenants.rotate_api_key(tenant, body.get("api_key"))
        except ValueError as e:
            return _err(409, "VEC_ERR_DIM", str(e))
        if new_key is None:
            return _err(404, "VEC_ERR_NOT_FOUND", "tenant not found")
        self.engine.audit.log(tenant, self._actor(request), "tenant.apikey.rotate", tenant)
        return web.json_response({"api_key": new_key})

    async def create_user(self, request: web.Request) -> web.Response:
        tenant = request.match_info["tenant"]
        deny = self._authorize(request, Permission.USER_MANAGE, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        user_id = body.get("user")
        if not user_id or not is_valid_name(user_id):
            return _err(400, "VEC_ERR_DIM", "user required")
        try:
            role = Role.parse(body.get("role", "READER"))
            u = self.engine.users.create_user(tenant, user_id, role, body.get("api_key"))
        except ValueError as e:
            return _err(409, "VEC_ERR_DIM", str(e))
        self.engine.audit.log(tenant, self._actor(request), "user.create",
                              f"{tenant}/{user_id}", {"role": role.name})
        return web.json_response(
            {"user": user_id, "role": role.name, "api_key": u.api_key}, status=201
        )

    async def list_users(self, request: web.Request) -> web.Response:
        tenant = request.match_info["tenant"]
        deny = self._authorize(request, Permission.USER_MANAGE, tenant)
        if deny:
            return deny
        return web.json_response(
            [{"user": u.user_id, "role": u.role.name} for u in self.engine.users.list_users(tenant)]
        )

    async def update_user_role(self, request: web.Request) -> web.Response:
        tenant, user = request.match_info["tenant"], request.match_info["user"]
        deny = self._authorize(request, Permission.USER_MANAGE, tenant)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        try:
            role = Role.parse(body.get("role", ""))
        except ValueError as e:
            return _err(400, "VEC_ERR_DIM", str(e))
        if not self.engine.users.update_role(tenant, user, role):
            return _err(404, "VEC_ERR_NOT_FOUND", "user not found")
        self.engine.audit.log(tenant, self._actor(request), "user.role.update",
                              f"{tenant}/{user}", {"role": role.name})
        return web.json_response({"user": user, "role": role.name})

    async def delete_user(self, request: web.Request) -> web.Response:
        tenant, user = request.match_info["tenant"], request.match_info["user"]
        deny = self._authorize(request, Permission.USER_MANAGE, tenant)
        if deny:
            return deny
        if not self.engine.users.delete_user(tenant, user):
            return _err(404, "VEC_ERR_NOT_FOUND", "user not found")
        self.engine.audit.log(tenant, self._actor(request), "user.delete", f"{tenant}/{user}")
        return web.json_response({"status": "deleted"})

    # ---- cache controller --------------------------------------------------------

    async def get_cache_policies(self, request: web.Request) -> web.Response:
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        store = getattr(self.engine.policy, "store", None)
        if store is None:
            return web.json_response({"engine": type(self.engine.policy).__name__})
        cfg = store.current
        return web.json_response(
            {"enable_cache": cfg.enable_cache, "default_ttl_seconds": cfg.default_ttl_seconds}
        )

    async def put_cache_policies(self, request: web.Request) -> web.Response:
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        store = getattr(self.engine.policy, "store", None)
        if store is None:
            return _err(400, "VEC_ERR_DIM", "policy engine is not dynamic")
        cur = store.current
        store.update(
            CachePolicyConfig(
                enable_cache=bool(body.get("enable_cache", cur.enable_cache)),
                default_ttl_seconds=float(
                    body.get("default_ttl_seconds", cur.default_ttl_seconds)
                ),
            )
        )
        self.engine.audit.log("-", self._actor(request), "cache.policy.update", "-", body)
        return web.json_response({"status": "updated"})

    async def cache_alias(self, request: web.Request) -> web.Response:
        """Register an L0.5 canonical alias (the reference feeds its
        CanonicalKeyMap from LLM query normalization; this is the produce
        side of that loop — callable by the sidecar or offline jobs).
        Requires POLICY_UPDATE on the body's tenant (admin bypasses)."""
        body, bad = await _json_body(request)
        if bad:
            return bad
        deny = self._authorize(request, Permission.POLICY_UPDATE, body.get("tenant"))
        if deny:
            return deny
        alias = body.get("alias_hash")
        canonical = body.get("canonical_hash")
        if not alias or not canonical:
            return _err(400, "VEC_ERR_DIM", "alias_hash and canonical_hash required")
        self.engine.canonical.set_alias(
            alias, canonical,
            confidence=float(body.get("confidence", 1.0)),
            ttl_seconds=float(body.get("ttl_seconds", 3600.0)),
            tenant=str(body.get("tenant") or ""),
        )
        return web.json_response({"status": "registered"})

    async def cache_flush(self, request: web.Request) -> web.Response:
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        n = self.engine.flush_cache()
        self.engine.audit.log("-", self._actor(request), "cache.flush", "-", {"removed": n})
        return web.json_response({"removed": n})

    async def cache_invalidate(self, request: web.Request) -> web.Response:
        body, bad = await _json_body(request)
        if bad:
            return bad
        tenant = body.get("tenant")
        if not tenant:
            return _err(400, "VEC_ERR_DIM", "tenant required")
        deny = self._authorize(request, Permission.CACHE_INVALIDATE, tenant)
        if deny:
            return deny
        n = self.engine.invalidate_cache(tenant, body.get("index"))
        self.engine.audit.log(tenant, self._actor(request), "cache.invalidate",
                              f"{tenant}/{body.get('index') or '*'}", {"removed": n})
        return web.json_response({"removed": n})

    # ---- AI controller (sidecar proxy, ref: Controllers/AiController.cs) ----------

    def _sidecar_or_503(self, request) -> "tuple[object, Optional[web.Response]]":
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return None, deny
        if self.sidecar is None:
            return None, _err(503, "VEC_ERR_BUSY", "AI sidecar not connected")
        return self.sidecar, None

    async def ai_models(self, request: web.Request) -> web.Response:
        sc, deny = self._sidecar_or_503(request)
        if deny:
            return deny
        import asyncio

        return web.json_response(await asyncio.to_thread(sc.get_model_status))

    async def ai_train(self, request: web.Request) -> web.Response:
        sc, deny = self._sidecar_or_503(request)
        if deny:
            return deny
        import asyncio

        out = await asyncio.to_thread(sc.trigger_training)
        self.engine.audit.log("-", self._actor(request), "ai.model.train", "-", out)
        return web.json_response(out)

    async def ai_deploy(self, request: web.Request) -> web.Response:
        sc, deny = self._sidecar_or_503(request)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        import asyncio

        out = await asyncio.to_thread(
            sc.deploy_model, body.get("version", ""), body.get("canary_tenants") or []
        )
        self.engine.audit.log("-", self._actor(request), "ai.model.deploy", "-", out)
        return web.json_response(out)

    async def ai_rollback(self, request: web.Request) -> web.Response:
        sc, deny = self._sidecar_or_503(request)
        if deny:
            return deny
        import asyncio

        out = await asyncio.to_thread(sc.rollback_model)
        self.engine.audit.log("-", self._actor(request), "ai.model.rollback", "-", out)
        return web.json_response(out)

    async def ai_evaluations(self, request: web.Request) -> web.Response:
        sc, deny = self._sidecar_or_503(request)
        if deny:
            return deny
        import asyncio

        return web.json_response(await asyncio.to_thread(sc.get_evaluations))

    # ---- billing / audit / health ---------------------------------------------------

    async def billing_usage(self, request: web.Request) -> web.Response:
        tenant = request.query.get("tenantId")
        if tenant:
            deny = self._authorize(request, Permission.BILLING_READ, tenant)
            if deny:
                return deny
            return web.json_response({tenant: self.engine.billing.get_usage(tenant).to_dict()})
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        return web.json_response(
            {t: u.to_dict() for t, u in self.engine.billing.all_usage().items()}
        )

    async def audit_logs(self, request: web.Request) -> web.Response:
        tenant = request.query.get("tenantId")
        if tenant:
            deny = self._authorize(request, Permission.AUDIT_READ, tenant)
        else:
            deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        q = request.query
        try:
            since = float(q["since"]) if "since" in q else None
            until = float(q["until"]) if "until" in q else None
            limit = min(int(q.get("limit", 100)), 10_000)
        except ValueError:
            return _err(400, "VEC_ERR_DIM", "since/until/limit must be numeric")
        events = self.engine.audit.query(
            tenant_id=tenant,
            action=q.get("action"),
            since=since,
            until=until,
            limit=limit,
        )
        return web.json_response([e.to_dict() for e in events])

    async def audit_stats(self, request: web.Request) -> web.Response:
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        return web.json_response(self.engine.audit.stats())

    async def debug_trace(self, request: web.Request) -> web.Response:
        """Capture a torch.profiler trace for N seconds — the kernel-level
        complement of the per-request TRACE breakdown. CUPTI records the
        card's kernels from every thread of the process, so a trace taken
        while the executor threads serve shows the scan kernels by name.
        Writes ``pyrope_trace_<ms since epoch>.json`` (Chrome trace) under
        ``path``."""
        deny = self._authorize(request, Permission.SYSTEM_MANAGE, None)
        if deny:
            return deny
        body, bad = await _json_body(request)
        if bad:
            return bad
        seconds = min(float(body.get("seconds", 3.0)), 60.0)
        trace_dir = body.get("path", os.path.join(tempfile.gettempdir(), "pyrope_trace"))
        import asyncio

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if resolve_device(self.engine.config.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        out = os.path.join(trace_dir, f"pyrope_trace_{int(time.time() * 1e3)}.json")
        # started and stopped on the loop's thread (under python -m, the
        # one that imported torch): the profiler's first start in a process
        # must run there (Kineto refuses an executor thread), and takes
        # seconds (CUPTI's set-up) while the loop serves nothing; the
        # window runs from after that start
        with profile(activities=activities) as prof:
            await asyncio.sleep(seconds)
        await asyncio.to_thread(prof.export_chrome_trace, out)
        self.engine.audit.log("-", self._actor(request), "debug.trace",
                              trace_dir, {"seconds": seconds})
        return web.json_response({"status": "captured", "trace_dir": trace_dir,
                                  "seconds": seconds})

    async def health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def metrics(self, request: web.Request) -> web.Response:
        # /v1/* requires a key (only /v1/health is exempt): any valid
        # identity — admin, tenant, or user key — may scrape metrics.
        if self.engine.authenticator.enabled:
            key, is_admin = self._identity(request)
            known = (
                is_admin
                or (key and self.engine.tenants.tenant_for_api_key(key))
                or (key and self.engine.users.user_for_api_key(key))
            )
            if not known:
                return _err(401, "VEC_ERR_AUTH", "X-API-KEY header required")
        return web.Response(
            text=self.engine.metrics.to_prometheus(),
            content_type="text/plain",
            charset="utf-8",
        )
