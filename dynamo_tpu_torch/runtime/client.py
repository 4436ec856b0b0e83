"""Endpoint client: instance watching, routing modes, per-instance circuit breakers
(a copy of ``dynamo_tpu/runtime/client.py``).

A client watches the discovery prefix for its endpoint and keeps a live
instance table. Each request picks an instance by router mode:

- ``round_robin`` / ``random`` — load-agnostic spreading (DP across replicas).
- ``direct`` — pin to a specific instance id (used by the disagg path and by
  the KV router, which computes the instance id itself and then goes direct).

Instances that fail requests are routed around by a per-instance circuit
breaker rather than removed — discovery owns membership (lease expiry), the
client only routes around errors. The breaker opens after
``breaker_threshold`` consecutive failures, stays open for
``breaker_open_seconds``, then admits a single half-open probe whose outcome
closes or re-opens it. Workers announcing ``metadata={"draining": True}``
are ineligible for new requests while they finish in-flight work.

The watch loop reconnects on store failure with jittered exponential
backoff (it previously died permanently on the first hiccup); restarts and
staleness are exported via :func:`watch_snapshot` / :func:`breaker_snapshot`
into the frontend registry (``dynamo_client_*`` families). Parity:
reference `component/client.rs:56-150` and PushRouter modes
(`egress/push_router.rs:72-85`).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import sys
import time
import weakref
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.component import Endpoint, Instance, instance_prefix
from dynamo_tpu_torch.runtime.discovery import WatchEvent, WatchEventType
from dynamo_tpu_torch.runtime.engine import Context, EngineError
from dynamo_tpu_torch.runtime.transport import NoSuchSubjectError

logger = logging.getLogger(__name__)

DEFAULT_INHIBIT_SECONDS = 2.0

#: Breaker states as exported by ``dynamo_client_breaker_state``.
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2

_WATCH_BACKOFF_BASE = 0.05
_WATCH_BACKOFF_CAP = 5.0

#: Live clients, for metric snapshots (weak: a dropped client stops exporting).
_CLIENTS: "weakref.WeakSet[Client]" = weakref.WeakSet()


class NoInstancesError(RuntimeError):
    """No routable instance for an endpoint (none known, or the pinned one
    is gone/draining/broken). Carries the endpoint path and how many
    instances the client knew about, for debuggability at the call site."""

    def __init__(self, message: str, *, endpoint_path: str = "", known_instances: int = 0) -> None:
        super().__init__(message)
        self.endpoint_path = endpoint_path
        self.known_instances = known_instances


class CircuitBreaker:
    """Consecutive-failure breaker for one instance.

    closed --(threshold consecutive failures)--> open
    open --(open_seconds elapse)--> half-open, admitting ONE probe
    half-open --probe success--> closed / --probe failure--> open again
    """

    __slots__ = ("threshold", "open_seconds", "failures", "state", "_opened_at",
                 "_probe_inflight", "_probe_started")

    def __init__(self, threshold: int, open_seconds: float) -> None:
        self.threshold = max(1, threshold)
        self.open_seconds = open_seconds
        self.failures = 0
        self.state = BREAKER_CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    def _probe_live(self, now: float) -> bool:
        # A probe that never reported back (cancelled mid-flight) must not
        # wedge the breaker half-open forever.
        return self._probe_inflight and now - self._probe_started < max(self.open_seconds, 1.0)

    def allow(self, now: float) -> bool:
        """Side-effect-free routability check."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            return now - self._opened_at >= self.open_seconds and not self._probe_live(now)
        return not self._probe_live(now)  # half-open: one probe at a time

    def begin_attempt(self, now: float) -> None:
        """A request is actually being dispatched to this instance."""
        if self.state == BREAKER_OPEN and now - self._opened_at >= self.open_seconds:
            self.state = BREAKER_HALF_OPEN
        if self.state == BREAKER_HALF_OPEN:
            self._probe_inflight = True
            self._probe_started = now

    def record_success(self) -> None:
        self.failures = 0
        self.state = BREAKER_CLOSED
        self._probe_inflight = False

    def record_failure(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.failures += 1
        if self.state == BREAKER_HALF_OPEN or self.failures >= self.threshold:
            self.state = BREAKER_OPEN
            self._opened_at = now
        self._probe_inflight = False


class Client:
    def __init__(
        self,
        endpoint: Endpoint,
        *,
        router_mode: str = "round_robin",
        inhibit_seconds: float | None = None,
        max_attempts: int = 3,
        breaker_threshold: int | None = None,
    ) -> None:
        if router_mode not in ("round_robin", "random", "direct"):
            raise ValueError(f"unknown router mode: {router_mode}")
        self.endpoint = endpoint
        self.router_mode = router_mode
        self._instances: dict[int, Instance] = {}
        self._breakers: dict[int, CircuitBreaker] = {}
        if inhibit_seconds is None:
            inhibit_seconds = float(os.environ.get("DYN_CLIENT_BREAKER_OPEN_S", DEFAULT_INHIBIT_SECONDS))
        if breaker_threshold is None:
            breaker_threshold = int(os.environ.get("DYN_CLIENT_BREAKER_THRESHOLD", "3"))
        self._breaker_open_seconds = inhibit_seconds
        self._breaker_threshold = breaker_threshold
        self._max_attempts = max_attempts
        self._rr_counter = 0
        self._watch_task: asyncio.Task | None = None
        self._changed: asyncio.Event = asyncio.Event()
        self.watch_restarts = 0
        self._watch_down_since: float | None = None
        _CLIENTS.add(self)

    # -- instance table ----------------------------------------------------

    async def start(self) -> "Client":
        if self._watch_task is None:
            # Seed synchronously so the first generate() after start() sees
            # currently-registered instances; the watch (whose initial
            # snapshot upserts idempotently) then keeps the table live.
            await self._resync()
            self._watch_task = asyncio.create_task(self._watch_loop())
        return self

    def _apply(self, event: WatchEvent) -> None:
        if event.type is WatchEventType.PUT and event.value is not None:
            inst = Instance.from_bytes(event.value)
            self._instances[inst.instance_id] = inst
        elif event.type is WatchEventType.DELETE:
            lease_hex = event.key.rsplit(":", 1)[-1]
            iid = int(lease_hex, 16)
            self._instances.pop(iid, None)
            self._breakers.pop(iid, None)  # departed: drop breaker state
        self._changed.set()

    async def _resync(self) -> None:
        """Rebuild the instance table from a prefix scan. Watch replay only
        upserts, so deletions missed during a watch outage would otherwise
        leave phantom instances — reconcile against ground truth instead."""
        ep = self.endpoint
        prefix = instance_prefix(ep.namespace, ep.component, ep.name)
        fresh: dict[int, Instance] = {}
        for value in (await ep.runtime.store.get_prefix(prefix)).values():
            inst = Instance.from_bytes(value)
            fresh[inst.instance_id] = inst
        self._instances = fresh
        self._breakers = {iid: b for iid, b in self._breakers.items() if iid in fresh}
        self._changed.set()

    async def _watch_loop(self) -> None:
        ep = self.endpoint
        prefix = instance_prefix(ep.namespace, ep.component, ep.name)
        backoff = _WATCH_BACKOFF_BASE
        while True:
            try:
                async for event in ep.runtime.store.watch_prefix(prefix):
                    backoff = _WATCH_BACKOFF_BASE
                    self._watch_down_since = None
                    self._apply(event)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if self._watch_down_since is None:
                    self._watch_down_since = time.monotonic()
                self.watch_restarts += 1
                delay = backoff * random.uniform(0.5, 1.0)
                logger.warning(
                    "instance watch for %s failed (%s: %s); reconnecting in %.2fs (restart #%d)",
                    ep.path, type(exc).__name__, exc, delay, self.watch_restarts,
                )
                await asyncio.sleep(delay)
                backoff = min(backoff * 2.0, _WATCH_BACKOFF_CAP)
            else:
                # The store closed the stream cleanly — still a resubscribe.
                if self._watch_down_since is None:
                    self._watch_down_since = time.monotonic()
                self.watch_restarts += 1
                await asyncio.sleep(backoff * random.uniform(0.5, 1.0))
                backoff = min(backoff * 2.0, _WATCH_BACKOFF_CAP)
            try:
                await self._resync()
                self._watch_down_since = None
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.warning("instance resync for %s failed; will retry after next watch attempt", ep.path)

    def watch_staleness(self) -> float:
        """Seconds the instance watch has been down (0.0 while healthy)."""
        if self._watch_down_since is None:
            return 0.0
        return time.monotonic() - self._watch_down_since

    def instances(self) -> list[Instance]:
        return list(self._instances.values())

    def instance_ids(self) -> list[int]:
        return list(self._instances.keys())

    async def wait_for_instances(self, *, count: int = 1, timeout: float = 10.0) -> list[Instance]:
        await self.start()
        deadline = time.monotonic() + timeout
        while len(self._instances) < count:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self.endpoint.path}: {len(self._instances)}/{count} instances after {timeout}s"
                )
            self._changed.clear()
            try:
                await asyncio.wait_for(self._changed.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                continue
        return self.instances()

    # -- selection ---------------------------------------------------------

    def _breaker_for(self, instance_id: int) -> CircuitBreaker:
        b = self._breakers.get(instance_id)
        if b is None:
            b = self._breakers[instance_id] = CircuitBreaker(
                self._breaker_threshold, self._breaker_open_seconds
            )
        return b

    def _eligible(self) -> list[Instance]:
        now = time.monotonic()
        alive = list(self._instances.values())
        active = [i for i in alive if not i.metadata.get("draining")]
        pool = [
            i for i in active
            if (b := self._breakers.get(i.instance_id)) is None or b.allow(now)
        ]
        # Everything blocked is worse than trying a blocked one: degrade to
        # the non-draining set, then to anything alive, rather than fail.
        return pool or active or alive

    def _pick(self, instance_id: int | None) -> Instance:
        if instance_id is not None:
            inst = self._instances.get(instance_id)
            if inst is None:
                raise NoInstancesError(
                    f"instance {instance_id:x} not found for {self.endpoint.path} "
                    f"({len(self._instances)} instances known)",
                    endpoint_path=self.endpoint.path,
                    known_instances=len(self._instances),
                )
            if inst.metadata.get("draining"):
                raise NoInstancesError(
                    f"instance {instance_id:x} is draining for {self.endpoint.path} "
                    f"({len(self._instances)} instances known)",
                    endpoint_path=self.endpoint.path,
                    known_instances=len(self._instances),
                )
            b = self._breakers.get(instance_id)
            if b is not None and not b.allow(time.monotonic()):
                raise NoInstancesError(
                    f"instance {instance_id:x} breaker open for {self.endpoint.path} "
                    f"({len(self._instances)} instances known)",
                    endpoint_path=self.endpoint.path,
                    known_instances=len(self._instances),
                )
            return inst
        pool = self._eligible()
        if not pool:
            raise NoInstancesError(
                f"no live instances for {self.endpoint.path}",
                endpoint_path=self.endpoint.path,
                known_instances=len(self._instances),
            )
        if self.router_mode == "random":
            return random.choice(pool)
        self._rr_counter += 1
        return pool[self._rr_counter % len(pool)]

    def inhibit(self, instance_id: int) -> None:
        """Record one failure against ``instance_id`` (legacy name; the
        breaker opens after ``breaker_threshold`` consecutive failures)."""
        self._breaker_for(instance_id).record_failure()

    def breaker_states(self) -> dict[int, int]:
        """instance_id -> breaker state (0 closed / 1 half-open / 2 open)."""
        return {iid: b.state for iid, b in self._breakers.items()}

    # -- request path ------------------------------------------------------

    async def generate(
        self,
        request: Any,
        context: Context | None = None,
        *,
        instance_id: int | None = None,
    ) -> AsyncIterator[Any]:
        """Open a response stream on one instance (retrying across replicas).

        Retries only happen before the first response item — once tokens have
        flowed, a failure surfaces to the caller (no replay of partial
        streams, same stance as the reference).
        """
        context = context or Context()
        await self.start()
        transport = self.endpoint.runtime.transport
        attempts = self._max_attempts if instance_id is None else 1
        last_error: Exception | None = None
        for _ in range(attempts):
            inst = self._pick(instance_id)
            breaker = self._breaker_for(inst.instance_id)
            breaker.begin_attempt(time.monotonic())
            # Traced requests get a per-hop client span; its span_id becomes
            # the remote side's parent (injected via the hop context's trace,
            # which the transport forwards on the wire). Untraced internal
            # traffic pays nothing.
            span = None
            hop_ctx = context
            if context.trace is not None:
                from dynamo_tpu_torch.tracing import Span, trace_of

                span = Span(
                    "rpc_client", trace=trace_of(context), request_id=context.id,
                    endpoint=self.endpoint.path, instance=f"{inst.instance_id:x}",
                )
                span.__enter__()
                hop_ctx = context.child()
                hop_ctx.trace = span.context.to_dict()
            stream = transport.generate(inst.address, request, hop_ctx)
            try:
                try:
                    first = await anext(stream)
                except StopAsyncIteration:
                    breaker.record_success()
                    return
                except (NoSuchSubjectError, ConnectionError, OSError, EngineError) as exc:
                    breaker.record_failure()
                    logger.warning(
                        "instance %x failed pre-stream: %s (breaker %s, %d consecutive failures)",
                        inst.instance_id, exc,
                        {0: "closed", 1: "half-open", 2: "open"}[breaker.state],
                        breaker.failures,
                    )
                    last_error = exc
                    if span is not None:
                        span.__exit__(type(exc), exc, None)
                        span = None
                    continue
                breaker.record_success()
                yield first
                async for item in stream:
                    yield item
                return
            finally:
                await stream.aclose()
                if span is not None:
                    # Consumer walk-away (GeneratorExit/cancel) is not a span
                    # failure; real stream errors mark the span status=error.
                    et, ev, tb = sys.exc_info()
                    if et in (GeneratorExit, asyncio.CancelledError, StopAsyncIteration):
                        et, ev, tb = None, None, None
                    span.__exit__(et, ev, tb)
        if last_error is not None:
            raise last_error
        raise NoInstancesError(
            f"no attempt succeeded for {self.endpoint.path}",
            endpoint_path=self.endpoint.path,
            known_instances=len(self._instances),
        )

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None


# -- metric snapshots ---------------------------------------------------------
#
# The frontend registry syncs these on scrape (the kernel_fallbacks idiom):
# module-level views over every live client in the process, keyed for the
# dynamo_client_* label sets.


def watch_snapshot() -> dict[str, dict[str, float]]:
    """Per-endpoint ``{"restarts": n, "staleness": seconds}`` across clients."""
    out: dict[str, dict[str, float]] = {}
    for client in list(_CLIENTS):
        agg = out.setdefault(client.endpoint.path, {"restarts": 0.0, "staleness": 0.0})
        agg["restarts"] += client.watch_restarts
        agg["staleness"] = max(agg["staleness"], client.watch_staleness())
    return out


def breaker_snapshot() -> dict[tuple[str, str], int]:
    """(endpoint_path, instance_hex) -> breaker state across live clients."""
    out: dict[tuple[str, str], int] = {}
    for client in list(_CLIENTS):
        for iid, state in client.breaker_states().items():
            key = (client.endpoint.path, f"{iid:x}")
            out[key] = max(out.get(key, BREAKER_CLOSED), state)
    return out
