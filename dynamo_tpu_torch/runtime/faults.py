"""Deterministic fault injection for the serving stack (a copy of
``dynamo_tpu/runtime/faults.py``: same registry, grammar and ``DYN_FAULTS``
variable, so one spec arms both builds; the port's discovery store fires
``lease.keepalive`` and ``store.watch``, and the other points name seams the
port has not taken over yet).

A process-wide registry of *named fault points* threaded through the hot
seams of the stack (TCP connect/read/write, store ops, lease keep-alive,
engine step, KV-chunk send/recv, prefill execution). Chaos tests — and
operators reproducing an incident — arm faults with a compact spec and the
affected call sites fail deterministically; with nothing armed, every
injection site costs exactly one attribute check (``if FAULTS.armed:``), so
the plane is free on the hot path.

Grammar (``DYN_FAULTS`` env var or :meth:`FaultRegistry.arm`)::

    DYN_FAULTS="tcp.connect:drop@0.5,kv.chunk.send:corrupt@1,engine.step:crash@3"

Comma-separated ``point:action[@spec]`` entries:

- ``point`` — a key of :data:`FAULT_POINTS` (unknown points are rejected at
  arm time, so a typo fails loudly instead of silently never firing).
- ``action`` — ``drop`` raises :class:`DropFault` (a ``ConnectionError``);
  ``crash`` raises :class:`CrashFault` (a ``RuntimeError``); ``corrupt``
  returns ``"corrupt"`` from :meth:`FaultRegistry.fire` and the call site
  mutates its payload; ``delay`` sleeps ``DYN_FAULTS_DELAY_S`` (default
  0.05s) and returns ``"delay"``.
- ``spec`` — when omitted, the fault fires on every call. ``@N`` (int)
  fires on the Nth call only (1-based). ``@N+`` fires on every call from
  the Nth. ``@p`` with ``0 < p < 1`` fires with probability ``p`` from a
  per-point PRNG seeded by ``DYN_FAULTS_SEED`` (default 0) — same seed,
  same firing sequence, every run.

Determinism is the point: a chaos scenario that kills the third engine step
kills the third engine step on every machine, every time.
"""

from __future__ import annotations

import logging
import os
import random
import time
import zlib
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

#: Every named injection point in the stack, with where it lives. ``arm()``
#: validates against this registry and ``tools/check_fault_points.py`` fails
#: CI if any point is never armed by a chaos test.
FAULT_POINTS: dict[str, str] = {
    "tcp.connect": "runtime/tcp.py — caller-side asyncio.open_connection to a worker",
    "tcp.read": "runtime/tcp.py — caller-side response-frame read on the data plane",
    "tcp.write": "runtime/tcp.py — caller-side request-frame write on the data plane",
    "store.op": "runtime/store_server.py — StoreClient request/response call to the store",
    "store.watch": "runtime/discovery.py + store_server.py — per-event delivery on a prefix watch",
    "store.replicate": "runtime/replication.py — follower-side apply of one replicated mutation record",
    "store.promote": "runtime/replication.py — a follower's promotion to store leader",
    "lease.keepalive": "runtime/discovery.py — lease keep-alive refresh",
    "engine.step": "engine/service.py — one engine step in the service loop",
    "kv.chunk.send": "disagg/transfer.py — sender side of one v2 KV chunk",
    "kv.chunk.recv": "disagg/transfer.py — receiver ingest of one KV chunk",
    "prefill.exec": "disagg/prefill_worker.py — execution of one claimed prefill task",
    "sched.admit": "engine/core.py — admission of one waiting request into prefill (SLO sched seam)",
}

_ACTIONS = ("drop", "crash", "corrupt", "delay")


class FaultInjected(Exception):
    """Marker mixin: this exception was raised by the fault plane."""


class DropFault(FaultInjected, ConnectionError):
    """Injected connection-level failure (reads as a network drop)."""


class CrashFault(FaultInjected, RuntimeError):
    """Injected process/step-level failure (reads as a crash)."""


@dataclass
class _Plan:
    """One armed fault: parsed action + firing schedule + counters."""

    point: str
    action: str
    kind: str  # always | once | from | prob
    n: int = 0
    p: float = 0.0
    rng: random.Random | None = None
    calls: int = 0
    fired: int = 0
    raw: str = field(default="")

    def should_fire(self) -> bool:
        self.calls += 1
        if self.kind == "always":
            return True
        if self.kind == "once":
            return self.calls == self.n
        if self.kind == "from":
            return self.calls >= self.n
        assert self.rng is not None
        return self.rng.random() < self.p


def _parse_entry(entry: str, seed: int) -> _Plan:
    head, sep, spec = entry.partition("@")
    point, _, action = head.partition(":")
    point = point.strip()
    action = action.strip()
    if point not in FAULT_POINTS:
        known = ", ".join(sorted(FAULT_POINTS))
        raise ValueError(f"unknown fault point {point!r} (known: {known})")
    if action not in _ACTIONS:
        raise ValueError(f"unknown fault action {action!r} in {entry!r} (known: {_ACTIONS})")
    plan = _Plan(point=point, action=action, kind="always", raw=entry.strip())
    if sep:
        spec = spec.strip()
        if spec.endswith("+"):
            plan.kind, plan.n = "from", int(spec[:-1])
        elif "." in spec:
            p = float(spec)
            if not 0.0 < p < 1.0:
                raise ValueError(f"fault probability must be in (0, 1): {entry!r}")
            plan.kind, plan.p = "prob", p
            # Per-point stream: arming a second fault must not perturb the
            # firing sequence of the first.
            plan.rng = random.Random(seed ^ zlib.crc32(point.encode()))
        else:
            plan.kind, plan.n = "once", int(spec)
        if plan.kind in ("once", "from") and plan.n < 1:
            raise ValueError(f"fault call index is 1-based: {entry!r}")
    return plan


class FaultRegistry:
    """Process-wide fault plane. The hot-path contract is::

        if FAULTS.armed:          # one attribute check when nothing is armed
            FAULTS.fire("tcp.connect")

    ``fire`` raises for ``drop``/``crash`` plans, returns ``"corrupt"`` /
    ``"delay"`` for the call site to act on, and ``None`` when the point has
    no armed plan or the schedule says not this call.
    """

    def __init__(self) -> None:
        self.armed = False
        self._plans: dict[str, _Plan] = {}

    def arm(self, spec: str, *, seed: int | None = None) -> None:
        """Parse and arm ``spec`` (the ``DYN_FAULTS`` grammar). Replaces any
        previously armed plans. Empty spec disarms."""
        if seed is None:
            seed = int(os.environ.get("DYN_FAULTS_SEED", "0"))
        plans: dict[str, _Plan] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            plan = _parse_entry(entry, seed)
            plans[plan.point] = plan  # last entry per point wins
        self._plans = plans
        self.armed = bool(plans)
        if plans:
            logger.warning("fault plane armed: %s", ", ".join(p.raw for p in plans.values()))

    def disarm(self) -> None:
        self._plans = {}
        self.armed = False

    def fire(self, point: str) -> str | None:
        """Evaluate ``point`` against the armed plans (see class docstring)."""
        plan = self._plans.get(point)
        if plan is None or not plan.should_fire():
            return None
        plan.fired += 1
        logger.warning("fault fired: %s -> %s (call %d)", point, plan.action, plan.calls)
        if plan.action == "drop":
            raise DropFault(f"injected drop at {point} (call {plan.calls})")
        if plan.action == "crash":
            raise CrashFault(f"injected crash at {point} (call {plan.calls})")
        if plan.action == "delay":
            time.sleep(float(os.environ.get("DYN_FAULTS_DELAY_S", "0.05")))
            return "delay"
        return "corrupt"

    def fired(self, point: str) -> int:
        """How many times the plan at ``point`` has fired (0 if unarmed)."""
        plan = self._plans.get(point)
        return plan.fired if plan is not None else 0

    def counts(self) -> dict[str, dict[str, int]]:
        """Per-point ``{calls, fired}`` for armed plans (test introspection)."""
        return {pt: {"calls": p.calls, "fired": p.fired} for pt, p in self._plans.items()}


#: The process-wide registry. Call sites import this binding directly
#: (``from dynamo_tpu_torch.runtime.faults import FAULTS``) so the unarmed check is
#: a single attribute load on a module global.
FAULTS = FaultRegistry()

_env_spec = os.environ.get("DYN_FAULTS", "")
if _env_spec:
    FAULTS.arm(_env_spec)


__all__ = [
    "FAULT_POINTS",
    "FAULTS",
    "FaultRegistry",
    "FaultInjected",
    "DropFault",
    "CrashFault",
]
