"""Layered configuration: defaults -> TOML file -> environment (a copy of the
parts of ``dynamo_tpu/config.py`` the port reads).

Dataclass defaults, overlaid by a TOML file, overlaid by
``DYN_<SECTION>_<FIELD>`` environment variables — highest layer wins, as in
the JAX build, so one file and one environment configure both.

Env naming: section ``router_resync`` field ``backoff_s`` ->
``DYN_ROUTER_RESYNC_BACKOFF_S``. The TOML file is taken from ``DYN_CONFIG``
(path) unless given explicitly. The sections here are the ones the port
reads: the router's resync knobs and the SLO plane's (``[slo]``,
``[slo_sched]``, ``[tenant]``, ``[cache_aware]``); the other sections
(runtime, worker, store, anomaly and incident settings, ...) come with the
features that read them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tomllib
from typing import Any, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


_TRUTHY = ("1", "true", "yes", "on")


def env_flag(env: dict[str, str], key: str, default: bool = False) -> bool:
    """Parse a boolean env toggle (the one definition of 'truthy')."""
    raw = env.get(key)
    return default if raw is None else raw.strip().lower() in _TRUTHY


def _coerce(value: str, target_type: Any) -> Any:
    """Parse an env string into the field's annotated type."""
    if target_type is bool or target_type == "bool":
        return value.strip().lower() in _TRUTHY
    if target_type is int or target_type == "int":
        return int(value)
    if target_type is float or target_type == "float":
        return float(value)
    return value


def _field_types(cls) -> dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cls):
        t = f.type
        if isinstance(t, str):  # from __future__ annotations
            t = {"int": int, "float": float, "bool": bool, "str": str}.get(
                t.replace(" | None", ""), str
            )
        out[f.name] = t
    return out


def load_config(
    defaults: T,
    *,
    section: str,
    toml_path: str | os.PathLike | None = None,
    env: dict[str, str] | None = None,
    env_prefix: str = "DYN",
) -> T:
    """Overlay ``defaults`` (a dataclass instance) with the ``[section]``
    table of a TOML file and then with ``{env_prefix}_{SECTION}_{FIELD}``
    environment variables. Unknown TOML keys warn and are ignored."""
    env = os.environ if env is None else env
    cls = type(defaults)
    values = dataclasses.asdict(defaults)
    types = _field_types(cls)

    path = toml_path or env.get(f"{env_prefix}_CONFIG")
    if path:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        table = doc.get(section, {})
        for k, v in table.items():
            if k in values:
                values[k] = v
            else:
                logger.warning("config file %s: unknown key [%s] %s", path, section, k)

    for name, t in types.items():
        env_key = f"{env_prefix}_{section.upper()}_{name.upper()}"
        if env_key in env:
            try:
                values[name] = _coerce(env[env_key], t)
            except (ValueError, TypeError) as exc:
                raise ValueError(f"bad value for {env_key}: {env[env_key]!r}") from exc

    return cls(**values)


@dataclasses.dataclass
class RouterResyncSettings:
    """Router KV-event resync knobs (``router/events.py``).

    A frontend (re)start — or a dropped worker stream — rebuilds the prefix
    index from the workers' sequence-numbered snapshot feeds; these tune the
    reconnect discipline. Env: ``DYN_ROUTER_RESYNC_*``, TOML:
    ``[router_resync]``.
    """

    backoff_s: float = 0.2  # first reconnect delay after a dropped event stream
    max_backoff_s: float = 5.0  # reconnect delay ceiling


def load_router_resync_settings(**kw) -> RouterResyncSettings:
    return load_config(RouterResyncSettings(), section="router_resync", **kw)


@dataclasses.dataclass
class SloSettings:
    """Latency targets the deployment is accountable to.

    The north-star metric is goodput *under* these targets (tokens/sec from
    requests that attained them), not raw throughput. The port reads
    ``itl_p99_ms`` as the chunk-budget controller's ITL budget
    (``sched.build_chunk_controller``); the JAX build's frontend SLO
    accountant, which reads both, is not ported. Env: ``DYN_SLO_*``, TOML:
    ``[slo]``.
    """

    ttft_ms: float = 500.0  # p50 time-to-first-token target (north star)
    itl_p99_ms: float = 50.0  # per-request p99 inter-token-latency target


@dataclasses.dataclass
class SloSchedSettings:
    """Admission-control plane knobs (``dynamo_tpu_torch/sched``).

    The master toggle is the bare ``DYN_SLO_SCHED`` flag (not part of this
    section); these tune the plane once it is on. Env: ``DYN_SLO_SCHED_*``,
    TOML: ``[slo_sched]``.
    """

    ttft_budget_ms: float = 500.0  # tier-0 EDF deadline budget
    tier_stretch: float = 2.0  # deadline budget multiplier per priority tier
    # Path to a profiler-produced WorkerProfile JSON; empty = the predictor
    # runs on its online-corrected fallback and the router skips the
    # attainment term unless a profile is wired in code.
    profile: str = ""
    attainment_weight: float = 1.0  # router cost weight for predicted attainment
    # ITL-driven chunk-budget controller (shrinks chunk_prefill_tokens when
    # the live decode-step tail nears the ITL budget; see SloSettings).
    chunk_floor_tokens: int = 64
    chunk_shrink_at: float = 0.9
    chunk_relax_at: float = 0.5
    chunk_cooldown_steps: int = 8


@dataclasses.dataclass
class TenantSettings:
    """Default per-tenant admission quota (``dynamo_tpu_torch/sched/tenants``).

    Zeros mean unlimited. Env: ``DYN_TENANT_*``, TOML: ``[tenant]``.
    """

    rate_tokens_per_s: float = 0.0  # token-bucket refill rate (prompt tokens)
    burst_tokens: float = 0.0  # bucket capacity; 0 -> 2s of rate
    max_inflight_tokens: int = 0  # cap on a tenant's live prompt tokens
    # JSON object of per-tenant overrides keyed by tenant id, e.g.
    # '{"heavy": {"rate_tokens_per_s": 1000, "max_inflight_tokens": 4096}}'.
    quotas: str = ""


@dataclasses.dataclass
class CacheAwareSettings:
    """Cache-aware serving knobs (residual-cost admission + router term).

    The master toggle is the bare ``DYN_CACHE_AWARE`` flag (not part of
    this section); these tune the plane once it is on. Env:
    ``DYN_CACHE_AWARE_*``, TOML: ``[cache_aware]``.
    """

    weight: float = 1.0  # router cost weight for predicted residual prefill
    # Prefill throughput assumed when converting residual tokens into
    # seconds of predicted TTFT contribution for the router cost.
    rate_tokens_per_s: float = 20000.0
    # Router skips the cache term for a worker whose KV-event feed is
    # staler than this — a stale index must not skew placement.
    max_staleness_s: float = 10.0


def load_slo_settings(**kw) -> SloSettings:
    return load_config(SloSettings(), section="slo", **kw)


def load_slo_sched_settings(**kw) -> SloSchedSettings:
    return load_config(SloSchedSettings(), section="slo_sched", **kw)


def load_tenant_settings(**kw) -> TenantSettings:
    return load_config(TenantSettings(), section="tenant", **kw)


def load_cache_aware_settings(**kw) -> CacheAwareSettings:
    return load_config(CacheAwareSettings(), section="cache_aware", **kw)
