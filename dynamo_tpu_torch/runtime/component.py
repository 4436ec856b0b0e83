"""Hierarchical component model: Namespace -> Component -> Endpoint -> Instance
(a copy of ``dynamo_tpu/runtime/component.py``; instance keys, subjects and
records are the JAX build's).

An *instance* is one live served endpoint, identified by the lease id of the
process serving it; its discovery record carries the transport address of its
stream server. Liveness is the lease: when a worker dies, its lease expires,
its instance records vanish, and every watching client drops it from rotation
— membership is fully dynamic with no explicit deregistration needed.

Parity: reference `lib/runtime/src/component.rs:106-419` (addressing), etcd
instance path scheme `component.rs:69` and NATS subject scheme
`component.rs:380-391`, DistributedRuntime `lib/runtime/src/distributed.rs`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from dataclasses import dataclass, field
from typing import Any

from dynamo_tpu_torch.runtime.discovery import DEFAULT_LEASE_TTL, KeyValueStore, Lease, MemoryStore
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.transport import InMemoryTransport, Transport

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z0-9_-]+$")

INSTANCE_PREFIX = "instances"


def _validate_name(name: str, kind: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid {kind} name {name!r}: must match [a-zA-Z0-9_-]+")
    return name


@dataclass(frozen=True)
class Instance:
    """One live served endpoint (discovery record)."""

    namespace: str
    component: str
    endpoint: str
    lease_id: int
    address: str  # transport address, e.g. tcp://host:port/subject or mem://subject
    metadata: dict[str, Any] = field(default_factory=dict, hash=False, compare=False)

    @property
    def instance_id(self) -> int:
        return self.lease_id

    @property
    def key(self) -> str:
        return instance_key(self.namespace, self.component, self.endpoint, self.lease_id)

    @property
    def subject(self) -> str:
        return instance_subject(self.namespace, self.component, self.endpoint, self.lease_id)

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "lease_id": self.lease_id,
                "address": self.address,
                "metadata": self.metadata,
            }
        ).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Instance":
        obj = json.loads(data)
        return cls(**obj)


def instance_prefix(namespace: str, component: str, endpoint: str) -> str:
    return f"{INSTANCE_PREFIX}/{namespace}/{component}/{endpoint}:"


def instance_key(namespace: str, component: str, endpoint: str, lease_id: int) -> str:
    return f"{instance_prefix(namespace, component, endpoint)}{lease_id:x}"


def instance_subject(namespace: str, component: str, endpoint: str, lease_id: int) -> str:
    return f"{namespace}.{component}.{endpoint}-{lease_id:x}"


class DistributedRuntime:
    """Cluster handle: discovery store + stream transport + primary lease.

    ``DistributedRuntime.detached()`` gives a fully in-process runtime (memory
    store + in-memory transport) — the one single-node serving and the tests
    use. The TCP store client and transport of multi-process deployments are
    not ported yet.
    """

    def __init__(
        self,
        store: KeyValueStore | None = None,
        transport: Transport | None = None,
        *,
        lease_ttl: float = DEFAULT_LEASE_TTL,
    ) -> None:
        self.store = store if store is not None else MemoryStore()
        self.transport = transport if transport is not None else InMemoryTransport()
        self._lease_ttl = lease_ttl
        self._primary_lease: Lease | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._secondary_tasks: list[asyncio.Task] = []
        self._served: list[tuple[str, str]] = []  # (subject, key)
        self._closed = False

    @classmethod
    def detached(cls) -> "DistributedRuntime":
        return cls(MemoryStore(), InMemoryTransport())

    # -- leases ------------------------------------------------------------

    async def primary_lease(self) -> Lease:
        if self._primary_lease is None:
            self._primary_lease = await self.store.create_lease(self._lease_ttl)
            self._keepalive_task = asyncio.create_task(self._keepalive_loop(self._primary_lease))
        return self._primary_lease

    async def secondary_lease(self, ttl: float | None = None) -> Lease:
        """An extra kept-alive lease: a distinct instance identity within this
        process (e.g. several engine workers sharing one runtime)."""
        lease = await self.store.create_lease(ttl if ttl is not None else self._lease_ttl)
        self._secondary_tasks.append(asyncio.create_task(self._keepalive_loop(lease)))
        return lease

    async def _keepalive_loop(self, lease: Lease) -> None:
        interval = max(lease.ttl / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                await lease.keep_alive()
            except KeyError:
                logger.error("primary lease %d expired; runtime is no longer discoverable", lease.id)
                return
            except Exception:
                logger.exception("lease keep-alive failed; retrying")

    # -- addressing --------------------------------------------------------

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, _validate_name(name, "namespace"))

    # -- lifecycle ---------------------------------------------------------

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        for t in self._secondary_tasks:
            t.cancel()
        for subject, key in self._served:
            await self.transport.unregister_engine(subject)
            try:
                await self.store.delete(key)
            except Exception:
                pass
        if self._primary_lease is not None:
            try:
                await self._primary_lease.revoke()
            except Exception:
                pass
        await self.transport.close()
        await self.store.close()


@dataclass(frozen=True)
class Namespace:
    runtime: DistributedRuntime
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, _validate_name(name, "component"))


@dataclass(frozen=True)
class Component:
    runtime: DistributedRuntime
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, _validate_name(name, "endpoint"))


@dataclass(frozen=True)
class Endpoint:
    runtime: DistributedRuntime
    namespace: str
    component: str
    name: str

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    async def serve(
        self,
        engine: AsyncEngine[Any, Any],
        *,
        metadata: dict[str, Any] | None = None,
        lease: Lease | None = None,
    ) -> Instance:
        """Bind ``engine`` to this endpoint and publish the instance record.

        The record is attached to the (primary) lease: if this process stops
        renewing, the instance disappears cluster-wide within one TTL.
        """
        rt = self.runtime
        if lease is None:
            lease = await rt.primary_lease()
        subject = instance_subject(self.namespace, self.component, self.name, lease.id)
        await rt.transport.register_engine(subject, engine)
        instance = Instance(
            namespace=self.namespace,
            component=self.component,
            endpoint=self.name,
            lease_id=lease.id,
            address=rt.transport.address_of(subject),
            metadata=metadata or {},
        )
        await rt.store.put(instance.key, instance.to_bytes(), lease_id=lease.id)
        rt._served.append((subject, instance.key))
        logger.info("serving %s as instance %x at %s", self.path, lease.id, instance.address)
        return instance

    def client(self, **kwargs: Any) -> "Client":
        from dynamo_tpu_torch.runtime.client import Client

        return Client(self, **kwargs)
