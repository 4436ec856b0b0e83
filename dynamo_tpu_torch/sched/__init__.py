"""SLO-native admission control plane (a copy of ``dynamo_tpu/sched``, which
imports no JAX; same names, settings and env knobs).

Converts the measurement planes (goodput accounting, profiler latency
surfaces, federated queue-depth gauges) into *control*:

- :class:`AdmissionController` — EDF-over-predicted-TTFT ordering of the
  engine's waiting queue plus per-tenant quota gating (``admission.py``).
- :class:`TenantRegistry` / :class:`TenantQuota` — token-bucket rate and
  in-flight caps keyed by the ``x-dynamo-tenant`` header (``tenants.py``).
- :class:`TtftPredictor` — profile-surface TTFT prediction with an
  online-corrected fallback (``predictor.py``).
- :class:`ChunkBudgetController` — shrinks/relaxes the mixed-step
  scheduler's ``chunk_prefill_tokens`` against the live ITL tail
  (``chunk_control.py``).

Master toggle: ``DYN_SLO_SCHED`` (default off — the engine's FIFO intake is
bit-identical to the pre-sched scheduler). The worker ``/metrics`` families
of the plane's counters are not ported (the counters live on the
controllers under the JAX names). Knobs: ``DYN_SLO_SCHED_*`` and
``DYN_TENANT_*`` (config.SloSchedSettings / TenantSettings). The router's
attainment-aware cost term is armed by the same toggle
(:func:`configure_attainment`).
"""

from __future__ import annotations

import logging
import os

from dynamo_tpu_torch.sched.admission import AdmissionConfig, AdmissionController
from dynamo_tpu_torch.sched.chunk_control import ChunkBudgetController
from dynamo_tpu_torch.sched.predictor import TtftPredictor
from dynamo_tpu_torch.sched.tenants import DEFAULT_TENANT, TenantQuota, TenantRegistry

logger = logging.getLogger(__name__)


def slo_sched_enabled(env=None) -> bool:
    """The master toggle: ``DYN_SLO_SCHED`` truthy."""
    from dynamo_tpu_torch.config import env_flag

    return env_flag(os.environ if env is None else env, "DYN_SLO_SCHED", False)


def _load_profile(path: str):
    from dynamo_tpu_torch.planner.core import WorkerProfile

    try:
        with open(path) as f:
            return WorkerProfile.from_json(f.read())
    except (OSError, ValueError) as exc:
        logger.warning("DYN_SLO_SCHED_PROFILE %s unusable (%s); using fallback predictor", path, exc)
        return None


def build_admission_controller(
    *, settings=None, tenant_settings=None, profile=None
) -> AdmissionController:
    """Assemble an AdmissionController from the config cascade
    (``[slo_sched]``/``[tenant]`` sections, ``DYN_SLO_SCHED_*`` /
    ``DYN_TENANT_*`` env). Explicit arguments override the cascade."""
    from dynamo_tpu_torch.config import load_slo_sched_settings, load_tenant_settings

    s = settings or load_slo_sched_settings()
    ts = tenant_settings or load_tenant_settings()
    if profile is None and s.profile:
        profile = _load_profile(s.profile)
    return AdmissionController(
        AdmissionConfig(ttft_budget_s=s.ttft_budget_ms / 1e3, tier_stretch=s.tier_stretch),
        predictor=TtftPredictor(profile),
        tenants=TenantRegistry.from_settings(ts),
    )


def build_chunk_controller(base_tokens: int, *, settings=None, slo=None) -> ChunkBudgetController:
    """Assemble the ITL-driven chunk-budget controller: the SLO section
    supplies the ITL budget, the slo_sched section the hysteresis knobs."""
    from dynamo_tpu_torch.config import load_slo_sched_settings, load_slo_settings

    s = settings or load_slo_sched_settings()
    slo = slo or load_slo_settings()
    return ChunkBudgetController(
        base_tokens,
        itl_budget_ms=slo.itl_p99_ms,
        floor_tokens=s.chunk_floor_tokens,
        shrink_at=s.chunk_shrink_at,
        relax_at=s.chunk_relax_at,
        cooldown_steps=s.chunk_cooldown_steps,
    )


def cache_aware_enabled(env=None) -> bool:
    """``DYN_CACHE_AWARE`` truthy: residual-cost admission pricing,
    cache-aware router cost, and (implicitly) async tier onboarding."""
    from dynamo_tpu_torch.config import env_flag

    return env_flag(os.environ if env is None else env, "DYN_CACHE_AWARE", False)


def configure_cache_aware(config, env=None, *, block_tokens=None, profile=None) -> None:
    """Arm a router ``SchedulerConfig``'s cache-aware cost term from the
    environment; a no-op unless ``DYN_CACHE_AWARE`` is on (same discipline
    as :func:`configure_attainment` — off means bit-identical costs).
    ``block_tokens`` lets the caller pass the deployment's real KV block
    size so predicted residual-prefill tokens are scaled correctly.

    The rate that converts residual prefill tokens into predicted seconds
    comes from the worker's *profiled* prefill throughput when one is
    available (``profile`` argument, else the ``DYN_SLO_SCHED_PROFILE``
    surface) — the 20k-tokens/s settings default is a guess that can skew
    placement by an order of magnitude on hardware it wasn't measured on.
    An explicit ``DYN_CACHE_AWARE_RATE_TOKENS_PER_S`` still wins: an
    operator override outranks a profile."""
    if not cache_aware_enabled(env):
        return
    from dynamo_tpu_torch.config import load_cache_aware_settings, load_slo_sched_settings

    e = os.environ if env is None else env
    s = load_cache_aware_settings(env=env) if env is not None else load_cache_aware_settings()
    config.cache_aware_weight = s.weight
    config.cache_max_staleness_s = s.max_staleness_s
    rate = s.rate_tokens_per_s
    if "DYN_CACHE_AWARE_RATE_TOKENS_PER_S" not in e:
        if profile is None:
            # configure_attainment may already have armed the config with
            # the DYN_SLO_SCHED_PROFILE surface; reuse it before re-reading.
            profile = getattr(config, "profile", None)
        if profile is None:
            ss = load_slo_sched_settings(env=env) if env is not None else load_slo_sched_settings()
            if ss.profile:
                profile = _load_profile(ss.profile)
        if profile is not None and getattr(profile, "prefill_tokens_per_sec", 0.0) > 0.0:
            rate = float(profile.prefill_tokens_per_sec)
    config.cache_rate_tokens_per_s = rate
    if block_tokens:
        config.cache_block_tokens = int(block_tokens)


def configure_attainment(config, env=None) -> None:
    """Arm a router ``SchedulerConfig``'s attainment cost term from the
    environment; a no-op unless ``DYN_SLO_SCHED`` is on. Mutates in place
    so callers that built their own config keep full control."""
    if not slo_sched_enabled(env):
        return
    from dynamo_tpu_torch.config import load_slo_sched_settings

    s = load_slo_sched_settings(env=env) if env is not None else load_slo_sched_settings()
    config.attainment_weight = s.attainment_weight
    config.ttft_slo_s = s.ttft_budget_ms / 1e3
    if config.profile is None and s.profile:
        config.profile = _load_profile(s.profile)


__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "ChunkBudgetController",
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantRegistry",
    "TtftPredictor",
    "build_admission_controller",
    "build_chunk_controller",
    "cache_aware_enabled",
    "configure_attainment",
    "configure_cache_aware",
    "slo_sched_enabled",
]
