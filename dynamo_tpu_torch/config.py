"""Layered configuration: defaults -> TOML file -> environment (a copy of the
parts of ``dynamo_tpu/config.py`` the port reads).

Dataclass defaults, overlaid by a TOML file, overlaid by
``DYN_<SECTION>_<FIELD>`` environment variables — highest layer wins, as in
the JAX build, so one file and one environment configure both.

Env naming: section ``router_resync`` field ``backoff_s`` ->
``DYN_ROUTER_RESYNC_BACKOFF_S``. The TOML file is taken from ``DYN_CONFIG``
(path) unless given explicitly. The other sections (runtime, worker, store,
SLO, anomaly and incident settings, ...) come with the features that read
them.
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
