"""Per-tenant QoS enforcement.

Rebuild of the reference's ``TenantQuotaEnforcer``
(ref: Services/TenantQuotaEnforcer.cs): per-second QPS window (:137-158),
concurrency gate handing out a disposable lease (:14-34, 160-189), daily
request limit, and monthly proxy-cost accumulation backing ``is_over_budget``
(:94-135) which the search path uses for budget degradation (halved
MaxScans, ref: VectorCommandSet.cs:439-456).
"""

from __future__ import annotations

import threading
from typing import Optional

from pyrope_tpu_torch.server.errors import VEC_ERR_BUSY, VEC_ERR_QUOTA
from pyrope_tpu_torch.service.tenants import TenantRegistry
from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


class TenantRequestLease:
    """Disposable concurrency lease (ref: TenantRequestLease :14-34)."""

    def __init__(self, on_release):
        self._on_release = on_release
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._on_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class _TenantState:
    __slots__ = (
        "qps_window_start", "qps_count", "concurrent",
        "month_key", "month_cost", "day_key", "day_count",
    )

    def __init__(self):
        self.qps_window_start = -1.0
        self.qps_count = 0
        self.concurrent = 0
        self.month_key = ""
        self.month_cost = 0.0
        self.day_key = ""
        self.day_count = 0


class TenantQuotaEnforcer:
    def __init__(self, registry: TenantRegistry, clock: Clock = SYSTEM_CLOCK):
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._states: dict[str, _TenantState] = {}

    def _state(self, tenant: str) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            st = self._states[tenant] = _TenantState()
        return st

    def _day_key(self) -> str:
        return str(int(self._clock.now() // 86400))

    def _month_key(self) -> str:
        # 30-day proxy months keep this free of calendar math; the reference
        # also accumulates into coarse windows.
        return str(int(self._clock.now() // (30 * 86400)))

    def try_begin_request(
        self, tenant: str
    ) -> tuple[bool, Optional[TenantRequestLease], Optional[str], Optional[str]]:
        """(ok, lease, error_code, error_message). Unknown tenants pass
        (ref behavior: no config → no limits)."""
        cfg = self._registry.try_get(tenant)
        if cfg is None or cfg.quotas is None:
            return True, None, None, None
        q = cfg.quotas
        now = self._clock.now()
        with self._lock:
            st = self._state(tenant)
            # check every gate BEFORE consuming any slot, so a rejection on
            # one gate never burns quota on another (a concurrency-rejected
            # retry storm must not exhaust the daily limit)
            if q.max_qps is not None:
                window = float(int(now))
                if st.qps_window_start != window:
                    st.qps_window_start = window
                    st.qps_count = 0
                if q.max_qps <= 0 or st.qps_count >= q.max_qps:
                    return False, None, VEC_ERR_QUOTA, "Tenant QPS limit exceeded."
            if q.daily_request_limit is not None:
                dk = self._day_key()
                if st.day_key != dk:
                    st.day_key = dk
                    st.day_count = 0
                if st.day_count >= q.daily_request_limit:
                    return False, None, VEC_ERR_QUOTA, "Tenant daily request limit exceeded."
            if q.max_concurrent_requests is not None and (
                q.max_concurrent_requests <= 0
                or st.concurrent >= q.max_concurrent_requests
            ):
                return False, None, VEC_ERR_BUSY, "Tenant concurrency limit exceeded."
            # all gates pass: consume
            if q.max_qps is not None:
                st.qps_count += 1
            if q.daily_request_limit is not None:
                st.day_count += 1
            lease: Optional[TenantRequestLease] = None
            if q.max_concurrent_requests is not None:
                st.concurrent += 1
                lease = TenantRequestLease(lambda: self._release(tenant))
            return True, lease, None, None

    def _release(self, tenant: str) -> None:
        with self._lock:
            st = self._states.get(tenant)
            if st is not None and st.concurrent > 0:
                st.concurrent -= 1

    # ---- budget (ref :94-135) --------------------------------------------

    def record_cost(self, tenant: str, cost: float) -> None:
        if cost <= 0:
            return
        mk = self._month_key()
        with self._lock:
            st = self._state(tenant)
            if st.month_key != mk:
                st.month_key = mk
                st.month_cost = 0.0
            st.month_cost += cost

    def is_over_budget(self, tenant: str) -> bool:
        cfg = self._registry.try_get(tenant)
        if cfg is None or cfg.quotas is None or cfg.quotas.monthly_budget is None:
            return False
        mk = self._month_key()
        with self._lock:
            st = self._state(tenant)
            if st.month_key != mk:
                return False
            return st.month_cost > cfg.quotas.monthly_budget

    def month_cost(self, tenant: str) -> float:
        with self._lock:
            st = self._states.get(tenant)
            return 0.0 if st is None else st.month_cost
