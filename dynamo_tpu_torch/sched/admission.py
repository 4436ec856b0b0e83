"""EDF admission control over predicted TTFT (a copy of
``dynamo_tpu/sched/admission.py``).

Replaces the engine's FIFO intake (behind ``DYN_SLO_SCHED``): each step,
``prepare()`` reorders the waiting queue by *deadline slack* —

    slack = (arrival + budget * stretch^tier) - (now + predicted_ttft)

— least slack first, and gates the head at the tenant quotas. Throttled
requests sink behind admissible ones but keep their EDF order among
themselves, so a released quota resumes in deadline order, and a stretched
tier's deadline still arrives eventually: priority tiers relax, they never
starve (batch-tier aging is the anti-starvation mechanism, Llumnix-style
priority isolation without a separate queue per tier).

The controller is policy only — it never allocates pages or touches runner
state. The engine's budget/page logic runs unchanged on the reordered
queue, which is what keeps ``DYN_SLO_SCHED=0`` bit-identical to the legacy
scheduler: with no controller attached the queue is never reordered.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from dynamo_tpu_torch.sched.predictor import TtftPredictor
from dynamo_tpu_torch.sched.tenants import DEFAULT_TENANT, TenantRegistry


@dataclass
class AdmissionConfig:
    ttft_budget_s: float = 0.5  # tier-0 deadline budget (the TTFT SLO)
    tier_stretch: float = 2.0  # deadline budget multiplier per priority tier
    max_tier: int = 3  # priorities clamp into [0, max_tier]


class AdmissionController:
    """EDF-over-predicted-TTFT ordering + tenant quota gating."""

    def __init__(
        self,
        config: AdmissionConfig | None = None,
        *,
        predictor: TtftPredictor | None = None,
        tenants: TenantRegistry | None = None,
        clock=time.monotonic,
    ) -> None:
        self.config = config or AdmissionConfig()
        self.predictor = predictor or TtftPredictor()
        self.tenants = tenants or TenantRegistry()
        self._clock = clock
        # seq_id -> (tenant, charged_tokens): live quota charges.
        self._charges: dict[int, tuple[str, int]] = {}
        self.deadline_misses = 0  # admitted after their deadline had passed
        self.admitted_total = 0
        self.throttle_events = 0
        self.last_slack_ms = 0.0  # min slack across waiting at the last prepare
        # Residual-cost pricing (DYN_CACHE_AWARE): the engine wires a
        # callable ``seq -> cached KV tokens`` (resident G1 match + local
        # tier probe). With it, prediction and quota charges price a request
        # by its *uncached* prefill tokens — a 95%-cached 3000-token prompt
        # stops costing the same as a cold one. None keeps the cache-blind
        # behaviour bit-identical.
        self.cached_tokens_fn = None

    def _cached_tokens(self, seq) -> int:
        """Admission-time cached-token estimate for ``seq`` (0 without a
        pricing hook). Clamped so at least one token is always charged —
        the final token computes no matter how warm the prefix is."""
        fn = self.cached_tokens_fn
        if fn is None:
            return 0
        try:
            est = int(fn(seq))
        except Exception:
            return 0  # estimate failure degrades to cache-blind pricing
        return max(0, min(est, len(seq.tokens) - 1))

    # -- identity ----------------------------------------------------------

    def tenant_of(self, seq) -> str:
        return getattr(seq.request, "tenant_id", None) or DEFAULT_TENANT

    def tier_of(self, seq) -> int:
        prio = int(getattr(seq.request, "priority", 0) or 0)
        return min(max(prio, 0), self.config.max_tier)

    def deadline(self, seq) -> float:
        budget = self.config.ttft_budget_s * self.config.tier_stretch ** self.tier_of(seq)
        return seq.arrival_time + budget

    # -- scheduling --------------------------------------------------------

    def prepare(self, waiting: deque, *, running: int, slots: int, now: float | None = None) -> int:
        """Reorder ``waiting`` in place (EDF slack order, quota-throttled
        requests last) and return how many head entries are admissible under
        the tenant quotas right now."""
        if not waiting:
            self.last_slack_ms = 0.0
            return 0
        now = self._clock() if now is None else now
        scored = []
        for seq in waiting:
            cached = self._cached_tokens(seq)
            pred = self.predictor.predict(
                queued_tokens=max(0, seq.prompt_remaining - cached),
                running=running,
                slots=slots,
            )
            seq.predicted_ttft_s = pred
            seq.predicted_at = now
            slack = self.deadline(seq) - (now + pred)
            scored.append((slack, seq.arrival_time, seq.seq_id, seq, cached))
        scored.sort(key=lambda t: (t[0], t[1], t[2]))
        self.last_slack_ms = scored[0][0] * 1e3
        admissible: list = []
        deferred: list = []
        planned_tokens: dict[str, float] = {}
        planned_inflight: dict[str, int] = {}
        for _, _, _, seq, cached in scored:
            if seq.seq_id in self._charges:
                # Preempted resume: charged at first admission, refunded only
                # at on_finish — the quota already accounts for the resources
                # it holds. Re-gating would count the request against itself
                # (a tenant whose sole live request exceeds its in-flight cap
                # could never resume: wedged forever).
                admissible.append(seq)
                continue
            tenant = self.tenant_of(seq)
            # Quota charge is the residual: cached blocks are a copy, not a
            # prefill, so the bucket pays only for compute the request will
            # actually demand (min 1 — the final token always computes).
            tokens = max(1, len(seq.tokens) - cached)
            if self.tenants.would_admit(
                tenant,
                tokens,
                planned_tokens=planned_tokens.get(tenant, 0.0),
                planned_inflight=planned_inflight.get(tenant, 0),
            ):
                planned_tokens[tenant] = planned_tokens.get(tenant, 0.0) + tokens
                planned_inflight[tenant] = planned_inflight.get(tenant, 0) + tokens
                admissible.append(seq)
            else:
                self.tenants.note_throttled(tenant)
                self.throttle_events += 1
                # Sticky marker for loss attribution: this request's eventual
                # pre-admission wait was (at least partly) the quota gate's
                # doing, not plain resource contention.
                seq.quota_deferred = True
                deferred.append(seq)
        waiting.clear()
        waiting.extend(admissible)
        waiting.extend(deferred)
        return len(admissible)

    # -- lifecycle hooks (engine calls these) ------------------------------

    def on_admit(self, seq, now: float | None = None) -> None:
        if seq.seq_id in self._charges:
            return  # preempted resume: quota already charged
        now = self._clock() if now is None else now
        tenant = self.tenant_of(seq)
        tokens = max(1, len(seq.tokens) - self._cached_tokens(seq))
        self.tenants.on_admit(tenant, tokens)
        self._charges[seq.seq_id] = (tenant, tokens)
        self.admitted_total += 1
        if now > self.deadline(seq):
            self.deadline_misses += 1

    def on_finish(self, seq) -> None:
        charge = self._charges.pop(seq.seq_id, None)
        if charge is not None:
            self.tenants.on_finish(*charge)

    def on_first_token(self, seq, now: float | None = None) -> None:
        """Close the prediction loop with the observed TTFT.

        ``predicted_ttft_s`` is the *remaining* TTFT estimated at the last
        ``prepare()``, so the observation must share that time origin —
        measuring from arrival would fold already-elapsed queue wait into
        the ratio and inflate the bias under load.
        """
        now = self._clock() if now is None else now
        origin = seq.predicted_at if seq.predicted_at is not None else seq.arrival_time
        self.predictor.observe(seq.predicted_ttft_s, now - origin)

    # -- introspection -----------------------------------------------------

    def queue_depth_by_tier(self, waiting) -> dict[int, int]:
        depth: dict[int, int] = {}
        for seq in waiting:
            tier = self.tier_of(seq)
            depth[tier] = depth.get(tier, 0) + 1
        return depth
