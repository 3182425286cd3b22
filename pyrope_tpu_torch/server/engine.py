"""The data-plane request pipeline (the port's copy of
``pyrope_tpu/server/engine.py``, bound to the port's registry).

Transport-agnostic rebuild of the reference's ``VectorCommandSet``
(ref: Extensions/VectorCommandSet.cs) — the component every RESP command and
HTTP controller routes through. The search flow mirrors the reference's
call stack (SURVEY §3.1):

    quota → auth → index lookup + dim check → policy.evaluate →
    cache cascade (L0 exact :210 → L0.5 alias :240-243 → L1 simhash
    :277-281 → L2 cluster + prefetch :316-386) → SLO shed :426-434 →
    degraded/budget search options :437-456 → index.search :458 →
    metadata join/filter :461-481 → cache set L0+L1+L2 :500-539

with the per-request TRACE breakdown (:884-912) and the write/delete paths
(:557-724). The engine is shared by the RESP server, the HTTP control
plane, and in-process embedding (`import pyrope_tpu_torch.server`), so tests
can drive the full pipeline without sockets — the analog of the reference's in-process Garnet
integration tests (SURVEY §4 pattern 2).

Every index lives on ``EngineConfig.device`` (``"cuda"`` unless the caller
asks for the CPU; CUDA on a host without a GPU raises). The device is used
in two places: the hot loop (the micro-batcher's ``index.search_batch``, or
``index.search``) and the L2 cluster path's prefetch search; everything
else — auth, quota, the host cache levels, metadata — is host work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from pyrope_tpu_torch.cache import (
    CanonicalKeyMap,
    LshService,
    MemoryCacheStorage,
    PolicyEngine,
    QueryKey,
    ResultCache,
    SemanticClusterRegistry,
    DynamicPolicyEngine,
)
from pyrope_tpu_torch.registry import VectorIndexRegistry
from pyrope_tpu_torch.security import AuthSettings, SessionAuthContext, TenantApiKeyAuthenticator
from pyrope_tpu_torch.server import errors as ec
from pyrope_tpu_torch.service import (
    AuditLogger,
    BillingLogStore,
    BillingMeter,
    MetricsCollector,
    SloGuardrails,
    SloGuardrailsOptions,
    SloMonitor,
    TenantQuotaEnforcer,
    TenantRegistry,
    TenantUserRegistry,
    VectorRecord,
    VectorStore,
    estimate_search_cost,
)
from pyrope_tpu_torch.service.cost import is_cluster_close_enough
from pyrope_tpu_torch.service.prefetch import PredictivePrefetcher, PrefetchBackgroundQueue
from pyrope_tpu_torch.types import IndexConfig, SearchOptions, SearchResult
from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from pyrope_tpu_torch.utils.naming import validate_name


@dataclasses.dataclass
class Hit:
    id: str
    score: float
    meta: Optional[dict] = None


@dataclasses.dataclass
class Trace:
    """Per-request breakdown (ref: VectorCommandSet.cs:884-912 — the TRACE
    JSON ``{requestId, cacheHit, latencyMs, policyMs, cacheMs, faissMs,
    metadataMs, budgetAdjustment}``; ``engine_ms`` is our ``faissMs``)."""

    request_id: str = ""
    cache_hit: bool = False
    cache_level: str = ""
    latency_ms: float = 0.0
    policy_ms: float = 0.0
    cache_ms: float = 0.0
    engine_ms: float = 0.0
    metadata_ms: float = 0.0
    budget_adjustment: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _SearchCont:
    """Opaque continuation between search_begin and search_resume: the
    validated request plus everything the host leg already computed. Owns
    the quota lease until search_resume's finally releases it."""

    tenant: str
    index: str
    q: np.ndarray
    top_k: int
    filter_tags: Sequence[str]
    with_meta: bool
    cache_hint_force: bool
    options: Optional[SearchOptions]
    tr: Optional["Trace"]
    t_start: float
    lease: object
    state: object
    key: object
    decision: object
    stats: object
    proxy_cost: float


@dataclasses.dataclass
class SearchResponse:
    ok: bool
    hits: list[Hit] = dataclasses.field(default_factory=list)
    error_code: Optional[str] = None
    error_message: Optional[str] = None
    trace: Optional[Trace] = None


@dataclasses.dataclass
class WriteResponse:
    ok: bool
    error_code: Optional[str] = None
    error_message: Optional[str] = None


@dataclasses.dataclass
class EngineConfig:
    auth: AuthSettings = dataclasses.field(default_factory=AuthSettings)
    slo: SloGuardrailsOptions = dataclasses.field(default_factory=SloGuardrailsOptions)
    billing_log_path: Optional[str] = None
    audit_log_path: Optional[str] = None
    enable_l1_simhash: bool = True
    enable_l2_cluster: bool = True
    # snapshot/load are confined to this directory (path-safety check,
    # ref: Controllers/IndexController.cs:298-309)
    snapshot_dir: str = "snapshots"
    # micro-batching scheduler: concurrent single queries share one device
    # batch (pyrope_tpu_torch/server/batcher.py). 0 disables.
    microbatch_max: int = 64
    microbatch_wait_ms: float = 0.5
    # concurrent device batches (see MicroBatcher.max_inflight); groups keep
    # absorbing arrivals while the gate is held, so coalescing tracks device
    # pressure instead of the fixed wait window. 0 = ungated.
    microbatch_inflight: int = 2
    # post-acquire hold (ms) that merges closed-loop cohorts on high-RTT
    # links (see MicroBatcher.linger_ms); 0 = off, right for co-located
    microbatch_linger_ms: float = 0.0
    # index-config persistence (ref: Services/IndexMetadataManager.cs);
    # definitions are restored on engine construction
    index_meta_path: Optional[str] = None
    # where every index lives ("cuda" unless the caller asks for "cpu");
    # checked by device.resolve_device, so "cuda" without a GPU raises
    device: str = "cuda"


class PyropeEngine:
    """One process-wide engine instance — the analog of the reference's DI
    singleton graph (ref: Program.cs:85-142)."""

    def __init__(self, config: Optional[EngineConfig] = None, clock: Clock = SYSTEM_CLOCK):
        self.config = config or EngineConfig()
        self.clock = clock
        self.tenants = TenantRegistry()
        self.users = TenantUserRegistry()
        self.authenticator = TenantApiKeyAuthenticator(
            self.tenants, self.users, self.config.auth
        )
        self.quota = TenantQuotaEnforcer(self.tenants, clock=clock)
        self.metrics = MetricsCollector()
        self.slo = SloGuardrails(self.config.slo)
        self.slo_monitor = SloMonitor(self.metrics, self.slo)
        self.billing_log = BillingLogStore(path=self.config.billing_log_path, clock=clock)
        self.billing = BillingMeter(log_store=self.billing_log, clock=clock)
        self.audit = AuditLogger(path=self.config.audit_log_path, clock=clock)
        self.store = VectorStore()
        self.registry = VectorIndexRegistry(self.config.device)
        self.cache_storage = MemoryCacheStorage(
            clock=clock,
            tenant_quota_mb=self.tenants.quota_cache_mb,
            on_eviction=self.metrics.record_eviction,
        )
        self.result_cache = ResultCache(self.cache_storage, self.registry.get_epoch)
        self.lsh = LshService()
        self.clusters = SemanticClusterRegistry(clock=clock)
        self.canonical = CanonicalKeyMap(clock=clock)
        self.policy: PolicyEngine = DynamicPolicyEngine()
        self.prefetcher = PredictivePrefetcher(clock=clock)
        self.prefetch_queue = PrefetchBackgroundQueue()
        from pyrope_tpu_torch.server.batcher import MicroBatcher

        self.batcher = (
            MicroBatcher(self.config.microbatch_max,
                         self.config.microbatch_wait_ms,
                         max_inflight=self.config.microbatch_inflight,
                         linger_ms=self.config.microbatch_linger_ms)
            if self.config.microbatch_max > 0
            else None
        )
        from pyrope_tpu_torch.service.index_metadata import IndexMetadataManager

        self.index_meta = IndexMetadataManager(self.config.index_meta_path)
        for tenant, index, cfg in self.index_meta.list_all():
            self.registry.create(tenant, index, cfg)

    # ------------------------------------------------------------------
    # auth (ref: VectorCommandSet.cs:726-749 — session ctx ∨ per-command key)
    # ------------------------------------------------------------------

    def _authenticate(self, tenant: str, api_key: Optional[str]) -> bool:
        if not self.authenticator.enabled:
            return True
        if SessionAuthContext.get_tenant() == tenant:
            return True
        if self.authenticator.is_admin_key(api_key):
            return True
        return self.authenticator.authenticate(tenant, api_key)

    def _tenant_priority(self, tenant: str) -> int:
        cfg = self.tenants.try_get(tenant)
        return 1 if cfg is None else cfg.quotas.priority

    # ------------------------------------------------------------------
    # VEC.SEARCH (ref: VectorCommandSet.cs:93-555)
    # ------------------------------------------------------------------

    def search(
        self,
        tenant: str,
        index: str,
        query: np.ndarray,
        top_k: int = 10,
        *,
        api_key: Optional[str] = None,
        filter_tags: Sequence[str] = (),
        with_meta: bool = False,
        trace: bool = False,
        request_id: str = "",
        cache_hint_force: bool = False,
        options: Optional[SearchOptions] = None,
    ) -> SearchResponse:
        """Full search pipeline (ref: VectorCommandSet.cs:180-539) —
        composition of the host-only leg and the device leg below."""
        resp, cont = self.search_begin(
            tenant, index, query, top_k, api_key=api_key,
            filter_tags=filter_tags, with_meta=with_meta, trace=trace,
            request_id=request_id, cache_hint_force=cache_hint_force,
            options=options,
        )
        if resp is not None:
            return resp
        return self.search_resume(cont)

    def search_begin(
        self,
        tenant: str,
        index: str,
        query: np.ndarray,
        top_k: int = 10,
        *,
        api_key: Optional[str] = None,
        filter_tags: Sequence[str] = (),
        with_meta: bool = False,
        trace: bool = False,
        request_id: str = "",
        cache_hint_force: bool = False,
        options: Optional[SearchOptions] = None,
    ) -> tuple[Optional[SearchResponse], Optional["_SearchCont"]]:
        """HOST-ONLY leg of the pipeline: quota lease, auth, key build,
        policy, and the host cache levels — L0 result cache, L0.5 canonical
        alias, L1 SimHash (dict lookups + a numpy hash; the L2 probe is NOT
        here because its centroid scoring runs on the device). Returns
        ``(response, None)`` when the request finishes here (hit or error),
        or ``(None, continuation)`` for :meth:`search_resume`, which owns
        the quota-lease release from that point on.

        The split exists for the async data plane: a cache HIT costs ~70 us
        of host work, while a thread-pool hop costs more than that by
        itself — so the RESP server runs this leg inline on the event loop
        and pays the executor only for misses (the cache's whole purpose is
        dodging device dispatch; dodging the thread hop completes it)."""
        t_start = time.perf_counter()
        tr = Trace(request_id=request_id) if trace else None

        ok, lease, code, msg = self.quota.try_begin_request(tenant)
        if not ok:
            return SearchResponse(False, error_code=code, error_message=msg), None
        handed_off = False
        try:
            if not self._authenticate(tenant, api_key):
                return SearchResponse(
                    False, error_code=ec.VEC_ERR_AUTH, error_message="authentication failed"
                ), None
            state = self.registry.try_get(tenant, index)
            if state is None:
                return SearchResponse(
                    False, error_code=ec.VEC_ERR_NOT_FOUND,
                    error_message=f"index not found: {tenant}:{index}",
                ), None
            q = np.asarray(query, dtype=np.float32).reshape(-1)
            if q.shape[0] != state.config.dim:
                return SearchResponse(
                    False, error_code=ec.VEC_ERR_DIM,
                    error_message=f"dim mismatch: expected {state.config.dim}, got {q.shape[0]}",
                ), None

            # --- policy (ref :200-204) ---------------------------------
            t0 = time.perf_counter()
            key = QueryKey.create(
                tenant, index, q, top_k, state.config.metric.value, tags=filter_tags
            )
            decision = self.policy.evaluate(key)
            if tr:
                tr.policy_ms = (time.perf_counter() - t0) * 1000

            # --- host cache levels (ref :210-281) -----------------------
            stats = state.index.get_stats()
            proxy_cost = estimate_search_cost(stats)
            hits: Optional[list[SearchResult]] = None
            level = ""
            t0 = time.perf_counter()
            if decision.should_cache:
                hits = self.result_cache.try_get(key)
                if hits is not None:
                    level = "L0"
                if hits is None:  # L0.5 canonical alias (ref :240-243)
                    # tenant-scoped alias first; fall back to the global
                    # namespace (admin-registered, no tenant in body) —
                    # skip the second probe when tenant IS the global ns
                    canon = self.canonical.try_get_canonical(
                        key.cache_hash(), tenant=tenant
                    )
                    if canon is None and tenant:
                        canon = self.canonical.try_get_canonical(key.cache_hash())
                    if canon is not None:
                        hits = self.result_cache.try_get_aliased(tenant, index, canon)
                        if hits is not None:
                            level = "L0.5"
                if hits is None and self.config.enable_l1_simhash:  # L1 (ref :277-281)
                    l1_key = key.with_simhash(int(self.lsh.simhash(q)))
                    hits = self.result_cache.try_get(l1_key)
                    if hits is not None:
                        level = "L1"
            if tr:
                tr.cache_ms = (time.perf_counter() - t0) * 1000

            if hits is not None:
                return self._finish_hit(
                    tenant, index, hits, level, filter_tags, with_meta,
                    top_k, tr, t_start,
                ), None

            handed_off = True
            return None, _SearchCont(
                tenant=tenant, index=index, q=q, top_k=top_k,
                filter_tags=filter_tags, with_meta=with_meta,
                cache_hint_force=cache_hint_force, options=options,
                tr=tr, t_start=t_start, lease=lease, state=state,
                key=key, decision=decision, stats=stats,
                proxy_cost=proxy_cost,
            )
        finally:
            if not handed_off and lease is not None:
                lease.release()

    def search_resume(self, cont: "_SearchCont") -> SearchResponse:
        """Device leg of the pipeline: L2 cluster probe (centroid scoring on
        the device), SLO shed, budget degradation, the engine dispatch
        (micro-batched), metadata join, and the cache set cascade
        (ref :316-539). Releases the quota lease taken by search_begin."""
        tenant, index, q = cont.tenant, cont.index, cont.q
        top_k, tr, t_start = cont.top_k, cont.tr, cont.t_start
        state, key, decision = cont.state, cont.key, cont.decision
        stats, proxy_cost = cont.stats, cont.proxy_cost
        try:
            # --- L2 cluster cache (ref :316-386) ------------------------
            cluster_id: Optional[int] = None
            hits: Optional[list[SearchResult]] = None
            t0 = time.perf_counter()
            if decision.should_cache and self.config.enable_l2_cluster:
                near = self.clusters.find_nearest_cluster(tenant, index, q)
                if near is not None:
                    cluster_id, score = near
                    self.prefetcher.record_interaction(tenant, index, cluster_id)
                    self._maybe_enqueue_prefetch(tenant, index, cluster_id, top_k)
                    if is_cluster_close_enough(
                        score, state.config.metric, proxy_cost
                    ):
                        l2_key = key.with_cluster(cluster_id)
                        hits = self.result_cache.try_get(l2_key)
            if tr:
                tr.cache_ms += (time.perf_counter() - t0) * 1000

            if hits is not None:
                return self._finish_hit(
                    tenant, index, hits, "L2", cont.filter_tags,
                    cont.with_meta, top_k, tr, t_start,
                )

            # --- miss path: SLO shed (ref :426-434) ---------------------
            self.metrics.record_miss()
            priority = self._tenant_priority(tenant)
            if cont.cache_hint_force or self.slo.should_force_cache_only(priority):
                self.billing.record_request(tenant, cache_hit=False)
                return SearchResponse(
                    False, error_code=ec.VEC_ERR_BUSY,
                    error_message="degraded: cache-only mode for this tenant",
                )

            # --- search options: degraded + budget (ref :437-456) -------
            opts = cont.options or SearchOptions()
            opts = self.slo.get_search_options(opts, priority)
            self.billing.record_compute(tenant, proxy_cost)
            self.quota.record_cost(tenant, proxy_cost)
            if self.quota.is_over_budget(tenant):
                cap = stats.count // 2 if stats.count > 0 else 0
                ms = cap if opts.max_scans is None else min(opts.max_scans, cap)
                opts = dataclasses.replace(opts, max_scans=ms)
                if tr:
                    tr.budget_adjustment = True

            # --- ★ the hot loop (ref :458); concurrent queries ride one
            # device batch through the micro-batcher. The index is searched
            # for the round_k-BUCKETED k (the cache identity, ref QueryKey
            # RoundK): a bucket-5 line filled by a top_k=3 query must still
            # satisfy a later top_k=5 query on the same bucket. ------------
            k_exec = max(top_k, key.top_k)
            t0 = time.perf_counter()
            if self.batcher is not None:
                raw = self.batcher.search(state.index, q, k_exec, opts)
            else:
                raw = state.index.search(q, k_exec, opts)
            if tr:
                tr.engine_ms = (time.perf_counter() - t0) * 1000

            joined = self._join_meta(
                tenant, index, raw, cont.filter_tags, cont.with_meta, k_exec, tr
            )
            out = joined[:top_k]
            self.billing.record_request(tenant, cache_hit=False)

            # --- cache set L0 + L1 + L2 (ref :500-539) ------------------
            if decision.should_cache:
                cacheable = [SearchResult(h.id, h.score) for h in joined]
                self.result_cache.set(key, cacheable, decision.ttl_seconds)
                if self.config.enable_l1_simhash:
                    self.result_cache.set(
                        key.with_simhash(int(self.lsh.simhash(q))),
                        cacheable, decision.ttl_seconds,
                    )
                if self.config.enable_l2_cluster and cluster_id is not None:
                    ttl = self.clusters.get_recommended_ttl(
                        tenant, index, cluster_id, decision.ttl_seconds
                    )
                    self.result_cache.set(key.with_cluster(cluster_id), cacheable, ttl)

            if tr:
                tr.latency_ms = (time.perf_counter() - t_start) * 1000
            self.metrics.record_search_latency((time.perf_counter() - t_start) * 1000)
            return SearchResponse(True, hits=out, trace=tr)
        finally:
            if cont.lease is not None:
                cont.lease.release()
                cont.lease = None

    def _finish_hit(
        self, tenant, index, hits, level, filter_tags, with_meta, top_k,
        tr, t_start,
    ) -> SearchResponse:
        self.metrics.record_hit()
        self.billing.record_request(tenant, cache_hit=True)
        out = self._join_meta(tenant, index, hits, filter_tags, with_meta, top_k, tr)
        if tr:
            tr.cache_hit = True
            tr.cache_level = level
            tr.latency_ms = (time.perf_counter() - t_start) * 1000
        self.metrics.record_search_latency((time.perf_counter() - t_start) * 1000)
        return SearchResponse(True, hits=out, trace=tr)

    def _join_meta(
        self,
        tenant: str,
        index: str,
        raw: list[SearchResult],
        filter_tags: Sequence[str],
        with_meta: bool,
        top_k: int,
        tr: Optional[Trace],
    ) -> list[Hit]:
        """Metadata join + tag filter + deleted skip (ref :461-481)."""
        t0 = time.perf_counter()
        want = set(filter_tags)
        out: list[Hit] = []
        for r in raw:
            rec = self.store.try_get(tenant, index, r.id)
            if rec is None:
                continue  # deleted after indexing
            if want and not want.issubset(set(rec.tags)):
                continue
            out.append(Hit(r.id, r.score, rec.meta if with_meta else None))
            if len(out) >= top_k:
                break
        if tr:
            tr.metadata_ms = (time.perf_counter() - t0) * 1000
        return out

    def _maybe_enqueue_prefetch(
        self, tenant: str, index: str, cluster_id: int, top_k: int
    ) -> None:
        """Warm the predicted next cluster off the hot path
        (ref: VectorCommandSet.cs:321-377 via PrefetchBackgroundQueue)."""
        nxt = self.prefetcher.get_prediction(tenant, index, cluster_id)
        if nxt is None:
            return
        cents = self.clusters.get_centroids(tenant, index)
        if cents is None or not (0 <= nxt < len(cents)):
            return
        centroid = np.array(cents[nxt], copy=True)

        def work():
            state = self.registry.try_get(tenant, index)
            if state is None:
                return
            key = QueryKey.create(
                tenant, index, centroid, top_k, state.config.metric.value,
                cluster_id=nxt,
            )
            # fill the whole round_k bucket (see the hot-loop k_exec note)
            raw = state.index.search(centroid, key.top_k)
            self.result_cache.set(key, raw, self.policy.evaluate(key).ttl_seconds)

        self.prefetch_queue.try_enqueue(work)

    # ------------------------------------------------------------------
    # VEC.ADD / VEC.UPSERT (ref: VectorCommandSet.cs:557-655)
    # ------------------------------------------------------------------

    def add(
        self,
        tenant: str,
        index: str,
        id: str,
        vector: np.ndarray,
        *,
        api_key: Optional[str] = None,
        meta: Optional[dict] = None,
        tags: Sequence[str] = (),
        numeric_fields: Optional[dict[str, float]] = None,
        upsert: bool = False,
    ) -> WriteResponse:
        ok, lease, code, msg = self.quota.try_begin_request(tenant)
        if not ok:
            return WriteResponse(False, code, msg)
        try:
            if not self._authenticate(tenant, api_key):
                return WriteResponse(False, ec.VEC_ERR_AUTH, "authentication failed")
            try:
                validate_name(tenant, "tenant")
                validate_name(index, "index")
            except ValueError as e:
                return WriteResponse(False, ec.VEC_ERR_DIM, str(e))
            v = np.asarray(vector, dtype=np.float32).reshape(-1)
            try:
                state = self.registry.try_get(tenant, index) or self.registry.get_or_create(
                    tenant, index, dim=v.shape[0]
                )
            except ValueError as e:
                return WriteResponse(False, ec.VEC_ERR_DIM, str(e))
            if v.shape[0] != state.config.dim:
                return WriteResponse(
                    False, ec.VEC_ERR_DIM,
                    f"dim mismatch: expected {state.config.dim}, got {v.shape[0]}",
                )
            record = VectorRecord(
                id=id, vector=v, meta=meta, tags=tuple(tags),
                numeric_fields=numeric_fields,
            )
            if upsert:
                delta = self.store.upsert(tenant, index, record)
                state.index.upsert(id, v)
                self.billing.record_vector_bytes(tenant, delta)
            else:
                if not self.store.try_add(tenant, index, record):
                    return WriteResponse(
                        False, ec.VEC_ERR_NOT_FOUND, f"id already exists: {id}"
                    )
                if not state.index.add(id, v):
                    state.index.upsert(id, v)  # tombstoned id resurrected
                self.billing.record_vector_bytes(tenant, record.nbytes())
            # write-heat for Semantic TTL (ref :636)
            near = self.clusters.find_nearest_cluster(tenant, index, v)
            if near is not None:
                self.clusters.record_write(tenant, index, near[0])
            # epoch bump invalidates every cached result (ref :638)
            self.registry.increment_epoch(tenant, index)
            return WriteResponse(True)
        finally:
            if lease is not None:
                lease.release()

    def write_batch(
        self,
        tenant: str,
        index: str,
        records: Sequence[VectorRecord],
        upserts: Sequence[bool],
        *,
        api_key: Optional[str] = None,
    ) -> list[WriteResponse]:
        """Coalesced per-row writes: N independent VEC.ADD/VEC.UPSERT
        requests executed as one engine pass — per-row add/upsert semantics
        and per-row results (so a duplicate ADD fails only its own row),
        but ONE quota lease, ONE auth check, ONE batched write-heat probe
        ([N, K] host matmul instead of N [1, K] probes), ONE billing record
        and ONE epoch bump. The RESP server's write coalescer
        (server/batcher.py AsyncWriteCoalescer) feeds this; counts as one
        request against QPS/concurrency quotas like add_batch."""
        n = len(records)
        ok, lease, code, msg = self.quota.try_begin_request(tenant)
        if not ok:
            return [WriteResponse(False, code, msg)] * n
        try:
            if not self._authenticate(tenant, api_key):
                return [WriteResponse(False, ec.VEC_ERR_AUTH,
                                      "authentication failed")] * n
            try:
                validate_name(tenant, "tenant")
                validate_name(index, "index")
            except ValueError as e:
                return [WriteResponse(False, ec.VEC_ERR_DIM, str(e))] * n
            try:
                state = self.registry.try_get(tenant, index) or self.registry.get_or_create(
                    tenant, index, dim=records[0].vector.shape[0]
                )
            except ValueError as e:
                return [WriteResponse(False, ec.VEC_ERR_DIM, str(e))] * n
            out: list[WriteResponse] = []
            delta_bytes = 0
            heat_vecs: list[np.ndarray] = []
            for rec, ups in zip(records, upserts):
                if rec.vector.shape[0] != state.config.dim:
                    out.append(WriteResponse(
                        False, ec.VEC_ERR_DIM,
                        f"dim mismatch: expected {state.config.dim}, "
                        f"got {rec.vector.shape[0]}",
                    ))
                    continue
                if ups:
                    delta_bytes += self.store.upsert(tenant, index, rec)
                    state.index.upsert(rec.id, rec.vector)
                else:
                    if not self.store.try_add(tenant, index, rec):
                        out.append(WriteResponse(
                            False, ec.VEC_ERR_NOT_FOUND,
                            f"id already exists: {rec.id}",
                        ))
                        continue
                    if not state.index.add(rec.id, rec.vector):
                        state.index.upsert(rec.id, rec.vector)
                    delta_bytes += rec.nbytes()
                heat_vecs.append(rec.vector)
                out.append(WriteResponse(True))
            self.billing.record_vector_bytes(tenant, delta_bytes)
            if heat_vecs:
                near = self.clusters.find_nearest_batch(
                    tenant, index, np.stack(heat_vecs)
                )
                if near is not None:
                    for cid in near[0]:
                        self.clusters.record_write(tenant, index, int(cid))
            self.registry.increment_epoch(tenant, index)
            return out
        finally:
            if lease is not None:
                lease.release()

    def add_batch(
        self,
        tenant: str,
        index: str,
        ids: Sequence[str],
        vectors: np.ndarray,
        *,
        api_key: Optional[str] = None,
    ) -> WriteResponse:
        """Bulk load (one device transfer, one epoch
        bump — the reference can only stream single VEC.UPSERTs). Counts as
        ONE request against QPS/concurrency quotas (it is one dispatch)."""
        ok, lease, code, msg = self.quota.try_begin_request(tenant)
        if not ok:
            return WriteResponse(False, code, msg)
        try:
            if not self._authenticate(tenant, api_key):
                return WriteResponse(False, ec.VEC_ERR_AUTH, "authentication failed")
            try:
                validate_name(tenant, "tenant")
                validate_name(index, "index")
            except ValueError as e:
                return WriteResponse(False, ec.VEC_ERR_DIM, str(e))
            vs = np.asarray(vectors, dtype=np.float32)
            if vs.ndim != 2 or len(ids) != vs.shape[0]:
                return WriteResponse(False, ec.VEC_ERR_DIM, "ids/vectors shape mismatch")
            try:
                state = self.registry.try_get(tenant, index) or self.registry.get_or_create(
                    tenant, index, dim=vs.shape[1]
                )
            except ValueError as e:
                return WriteResponse(False, ec.VEC_ERR_DIM, str(e))
            if vs.shape[1] != state.config.dim:
                return WriteResponse(False, ec.VEC_ERR_DIM, "dim mismatch")
            total = 0
            for i, v in zip(ids, vs):
                if self.store.try_add(tenant, index, VectorRecord(id=i, vector=v)):
                    total += v.nbytes + len(i)
            state.index.add_batch(ids, vs)
            self.billing.record_vector_bytes(tenant, total)
            self.registry.increment_epoch(tenant, index)
            return WriteResponse(True)
        finally:
            if lease is not None:
                lease.release()

    # ------------------------------------------------------------------
    # VEC.DEL (ref: VectorCommandSet.cs:657-724)
    # ------------------------------------------------------------------

    def delete(
        self, tenant: str, index: str, id: str, *, api_key: Optional[str] = None
    ) -> WriteResponse:
        ok, lease, code, msg = self.quota.try_begin_request(tenant)
        if not ok:
            return WriteResponse(False, code, msg)
        try:
            if not self._authenticate(tenant, api_key):
                return WriteResponse(False, ec.VEC_ERR_AUTH, "authentication failed")
            state = self.registry.try_get(tenant, index)
            if state is None:
                return WriteResponse(False, ec.VEC_ERR_NOT_FOUND, "index not found")
            found = self.store.try_mark_deleted(tenant, index, id)
            state.index.delete(id)
            if not found:
                return WriteResponse(False, ec.VEC_ERR_NOT_FOUND, f"id not found: {id}")
            self.registry.increment_epoch(tenant, index)
            return WriteResponse(True)
        finally:
            if lease is not None:
                lease.release()

    # ------------------------------------------------------------------
    # VEC.STATS (ref: VectorCommandSet.cs:104-133) + control-plane ops
    # ------------------------------------------------------------------

    def stats(self, tenant: str, index: str) -> Optional[dict]:
        state = self.registry.try_get(tenant, index)
        if state is None:
            return None
        s = state.index.get_stats()
        m = self.metrics.get_snapshot()
        out = {
            "count": s.count,
            "dim": s.dim,
            "metric": s.metric.value,
            "algorithm": state.config.algorithm,
            "epoch": state.epoch,
            "cache_hits": m.hits,
            "cache_misses": m.misses,
            "searches": m.searches,
        }
        if self.batcher is not None:
            out["microbatch"] = self.batcher.to_dict()
        return out

    def create_index(self, tenant: str, index: str, config: IndexConfig):
        validate_name(tenant, "tenant")
        validate_name(index, "index")
        state = self.registry.create(tenant, index, config)
        self.index_meta.save(tenant, index, config)
        return state

    def build_index(self, tenant: str, index: str) -> bool:
        """Compaction + centroid auto-sync + epoch bump
        (ref: Controllers/IndexController.cs:80-123)."""
        state = self.registry.try_get(tenant, index)
        if state is None:
            return False
        state.index.build()
        cents = state.index.get_centroids()
        if cents is not None:
            self.clusters.update_centroids(tenant, index, cents, state.config.metric)
        self.registry.increment_epoch(tenant, index)
        return True

    def _safe_snapshot_path(self, tenant: str, path: str) -> str:
        """Confine snapshot paths to the TENANT's own namespace under the
        snapshot dir (ref: IndexController.cs:298-309 path-safety check;
        per-tenant prefix prevents one tenant loading another's snapshot)."""
        import os

        base = os.path.abspath(os.path.join(self.config.snapshot_dir, tenant))
        full = os.path.abspath(os.path.join(base, path))
        if not (full == base or full.startswith(base + os.sep)):
            raise ValueError(f"path escapes snapshot dir: {path!r}")
        os.makedirs(os.path.dirname(full) or base, exist_ok=True)
        return full

    def snapshot_index(self, tenant: str, index: str, path: str) -> Optional[int]:
        """Persist index + record-of-truth; returns snapshot bytes (billed,
        ref: IndexController.cs:125-176). None if index missing."""
        import os

        state = self.registry.try_get(tenant, index)
        if state is None:
            return None
        full = self._safe_snapshot_path(tenant, path)
        state.index.snapshot(full)
        # persist the record-of-truth (meta/tags) alongside the index so a
        # restored search survives the metadata join
        records = self.store.export_records(tenant, index)
        import json as _json

        import numpy as np_

        np_.savez_compressed(
            full + ".store",
            ids=np_.array([r.id for r in records], dtype=np_.str_),
            vecs=(
                np_.stack([r.vector for r in records])
                if records else np_.zeros((0, state.config.dim), np_.float32)
            ),
            meta=np_.str_(_json.dumps([
                {"meta": r.meta, "tags": list(r.tags),
                 "numeric_fields": r.numeric_fields}
                for r in records
            ])),
        )
        nbytes = 0
        for p in (full, full + ".npz", full + ".head", full + ".tail",
                  full + ".store.npz"):
            if os.path.exists(p):
                nbytes += os.path.getsize(p)
        self.billing.record_snapshot(tenant, nbytes)
        return nbytes

    def load_index(self, tenant: str, index: str, path: str) -> bool:
        """Restore + epoch bump (ref: IndexController.cs:178-228)."""
        import os

        state = self.registry.try_get(tenant, index)
        if state is None:
            return False
        full = self._safe_snapshot_path(tenant, path)
        state.index.load(full)
        store_path = full + ".store.npz"
        if os.path.exists(store_path):
            import json as _json

            import numpy as np_

            with np_.load(store_path, allow_pickle=False) as z:
                ids = [str(s) for s in z["ids"]]
                vecs = np_.asarray(z["vecs"], np_.float32)
                extras = _json.loads(str(z["meta"]))
            records = [
                VectorRecord(
                    id=i, vector=v, meta=e["meta"],
                    tags=tuple(e["tags"] or ()),
                    numeric_fields=e["numeric_fields"],
                )
                for i, v, e in zip(ids, vecs, extras)
            ]
            self.store.import_records(tenant, index, records)
        self.registry.increment_epoch(tenant, index)
        return True

    def push_centroids(self, tenant: str, index: str, centroids: np.ndarray) -> bool:
        """External centroid push + epoch bump (the sidecar's
        SemanticModelTrainer posts here; ref: IndexController.cs:251-292)."""
        state = self.registry.try_get(tenant, index)
        if state is None:
            return False
        self.clusters.update_centroids(tenant, index, centroids, state.config.metric)
        self.registry.increment_epoch(tenant, index)
        return True

    def flush_cache(self) -> int:
        return self.cache_storage.clear()

    def invalidate_cache(self, tenant: str, index: Optional[str] = None) -> int:
        prefix = f"cache:{tenant}:{index}:" if index else f"cache:{tenant}:"
        return self.cache_storage.remove_by_prefix(prefix)

    def tick_background(self) -> None:
        """One iteration of the periodic work the reference runs in hosted
        services (ref: Program.cs:143-168): SLO monitor, prefetch flush,
        prefetch work queue, alias + cache-entry expiry sweeps."""
        self.slo_monitor.tick()
        self.prefetcher.tick()
        self.prefetch_queue.run_pending()
        self.canonical.cleanup_expired()
        self.cache_storage.sweep_expired()
