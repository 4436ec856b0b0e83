"""Per-tenant admission quotas: token bucket + in-flight cap (a copy of
``dynamo_tpu/sched/tenants.py``).

A tenant is whatever the frontend put in ``x-dynamo-tenant`` (requests
without one share the ``default`` tenant). Two independent limits, both
optional (0 = unlimited):

- **Rate** — a token bucket refilled at ``rate_tokens_per_s`` with capacity
  ``burst_tokens``. Admission charges the request's prompt tokens; a prompt
  larger than the bucket capacity borrows (the bucket goes negative) so an
  oversized request is delayed, never wedged forever.
- **In-flight** — total prompt tokens of the tenant's live sequences. A
  tenant with nothing in flight always fits one request, so the cap can
  never deadlock a tenant outright.

The registry only *answers* and *accounts*; the admission controller decides
order. Throttle decisions are counted per tenant (``throttled``; the JAX
build exports them as ``dynamo_tenant_throttled_total``, a worker metric
family the port has not taken over yet).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass


@dataclass
class TenantQuota:
    rate_tokens_per_s: float = 0.0  # 0 = unlimited rate
    burst_tokens: float = 0.0  # bucket capacity; 0 -> 2s of rate
    max_inflight_tokens: int = 0  # 0 = unlimited in-flight
    weight: float = 1.0  # fair-share weight across tiers (informational)

    @property
    def capacity(self) -> float:
        if self.burst_tokens > 0:
            return self.burst_tokens
        return 2.0 * self.rate_tokens_per_s


DEFAULT_TENANT = "default"


class TenantRegistry:
    """Quota state per tenant; the default quota covers unknown tenants."""

    def __init__(self, default_quota: TenantQuota | None = None, *, clock=time.monotonic) -> None:
        self.default_quota = default_quota or TenantQuota()
        self._quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, tuple[float, float]] = {}  # tenant -> (level, last_refill)
        self._inflight: dict[str, int] = {}
        self.throttled: dict[str, int] = {}  # cumulative throttle decisions
        self._clock = clock

    @classmethod
    def from_settings(cls, settings, *, clock=time.monotonic) -> "TenantRegistry":
        """Build from config.TenantSettings: the scalar fields set the
        default quota; ``quotas`` (JSON object keyed by tenant) overrides
        per tenant, e.g. ``{"heavy": {"rate_tokens_per_s": 1000}}``."""
        reg = cls(
            TenantQuota(
                rate_tokens_per_s=settings.rate_tokens_per_s,
                burst_tokens=settings.burst_tokens,
                max_inflight_tokens=settings.max_inflight_tokens,
            ),
            clock=clock,
        )
        if settings.quotas:
            for tenant, fields in json.loads(settings.quotas).items():
                base = reg.default_quota
                reg.configure(
                    tenant,
                    TenantQuota(
                        rate_tokens_per_s=float(fields.get("rate_tokens_per_s", base.rate_tokens_per_s)),
                        burst_tokens=float(fields.get("burst_tokens", base.burst_tokens)),
                        max_inflight_tokens=int(fields.get("max_inflight_tokens", base.max_inflight_tokens)),
                        weight=float(fields.get("weight", base.weight)),
                    ),
                )
        return reg

    def configure(self, tenant: str, quota: TenantQuota) -> None:
        self._quotas[tenant] = quota

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self.default_quota)

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def _bucket_level(self, tenant: str, q: TenantQuota) -> float:
        now = self._clock()
        level, last = self._buckets.get(tenant, (q.capacity, now))
        level = min(q.capacity, level + (now - last) * q.rate_tokens_per_s)
        self._buckets[tenant] = (level, now)
        return level

    def would_admit(
        self, tenant: str, tokens: int, *, planned_tokens: float = 0.0, planned_inflight: int = 0
    ) -> bool:
        """Could ``tokens`` prompt tokens be admitted for ``tenant`` now?
        ``planned_*`` account for requests the caller already marked
        admissible in the same scheduling pass (charged only on admit)."""
        q = self.quota(tenant)
        if q.rate_tokens_per_s > 0:
            level = self._bucket_level(tenant, q) - planned_tokens
            # Borrow semantics: an oversized prompt only needs a full bucket.
            if level < min(float(tokens), q.capacity):
                return False
        if q.max_inflight_tokens > 0:
            live = self.inflight(tenant) + planned_inflight
            if live > 0 and live + tokens > q.max_inflight_tokens:
                return False
        return True

    def note_throttled(self, tenant: str) -> None:
        self.throttled[tenant] = self.throttled.get(tenant, 0) + 1

    def on_admit(self, tenant: str, tokens: int) -> None:
        q = self.quota(tenant)
        if q.rate_tokens_per_s > 0:
            level = self._bucket_level(tenant, q)
            self._buckets[tenant] = (level - tokens, self._buckets[tenant][1])
        self._inflight[tenant] = self.inflight(tenant) + tokens

    def on_finish(self, tenant: str, tokens: int) -> None:
        self._inflight[tenant] = max(0, self.inflight(tenant) - tokens)
