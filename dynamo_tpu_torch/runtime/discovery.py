"""Discovery / liveness plane: a key-value store with leases and watch (a copy
of ``dynamo_tpu/runtime/discovery.py``'s in-process half).

This is the control-plane primitive under everything: instance registration,
model-card publication, worker load metrics. Semantics follow etcd: keys with
byte values, TTL leases that cascade-delete attached keys on expiry, and
prefix watches that stream PUT/DELETE events. Keys and values are the JAX
build's, so a worker of either build could share one store.

:class:`MemoryStore` is the in-process store. The TCP store server, its
replication and the ``adopt_lease`` hook replication needs are not ported
yet.
"""

from __future__ import annotations

import abc
import asyncio
import time
from dataclasses import dataclass
from enum import Enum
from typing import AsyncIterator

from dynamo_tpu_torch.runtime.faults import FAULTS


class WatchEventType(Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass(frozen=True)
class WatchEvent:
    type: WatchEventType
    key: str
    value: bytes | None  # None for DELETE


@dataclass
class Lease:
    """A liveness lease. Keys put with ``lease_id`` vanish when it expires.

    Default TTL mirrors the reference's 10s instance leases.
    """

    id: int
    ttl: float
    store: "KeyValueStore"

    async def keep_alive(self) -> None:
        await self.store.keep_alive(self.id)

    async def revoke(self) -> None:
        await self.store.revoke_lease(self.id)


DEFAULT_LEASE_TTL = 10.0


class KeyValueStore(abc.ABC):
    """etcd-shaped store: put/get/delete, prefix scan, TTL leases, prefix watch."""

    @abc.abstractmethod
    async def put(self, key: str, value: bytes, lease_id: int | None = None) -> None: ...

    @abc.abstractmethod
    async def get(self, key: str) -> bytes | None: ...

    @abc.abstractmethod
    async def get_prefix(self, prefix: str) -> dict[str, bytes]: ...

    @abc.abstractmethod
    async def delete(self, key: str) -> bool: ...

    @abc.abstractmethod
    async def create_lease(self, ttl: float = DEFAULT_LEASE_TTL) -> Lease: ...

    @abc.abstractmethod
    async def keep_alive(self, lease_id: int) -> None: ...

    @abc.abstractmethod
    async def revoke_lease(self, lease_id: int) -> None: ...

    @abc.abstractmethod
    def watch_prefix(self, prefix: str, initial: bool = True) -> AsyncIterator[WatchEvent]:
        """Stream PUT/DELETE events under ``prefix``.

        With ``initial=True`` the current contents are first replayed as PUT
        events, so a watcher's world-model starts complete.
        """
        ...

    @abc.abstractmethod
    async def put_if_absent(self, key: str, value: bytes, lease_id: int | None = None) -> bool:
        """Atomic create. Returns False if the key already exists."""
        ...

    async def close(self) -> None:  # pragma: no cover - default no-op
        pass


class MemoryStore(KeyValueStore):
    """In-process store with full lease/watch semantics.

    Lease expiry is enforced by a lazy sweep on access plus an optional
    background reaper task, so tests can drive expiry deterministically with
    short TTLs.
    """

    def __init__(self, *, reap_interval: float = 1.0, clock=time.monotonic) -> None:
        self._data: dict[str, bytes] = {}
        self._key_lease: dict[str, int] = {}
        self._leases: dict[int, float] = {}  # lease_id -> deadline
        self._lease_ttl: dict[int, float] = {}
        self._lease_keys: dict[int, set[str]] = {}
        self._watchers: list[tuple[str, asyncio.Queue[WatchEvent]]] = []
        self._lease_next = 1
        self._clock = clock
        self._reap_interval = reap_interval
        self._reaper: asyncio.Task | None = None
        self._lock = asyncio.Lock()

    # -- internal ----------------------------------------------------------

    def _notify(self, event: WatchEvent) -> None:
        for prefix, queue in self._watchers:
            if event.key.startswith(prefix):
                queue.put_nowait(event)

    def _delete_key_locked(self, key: str) -> bool:
        if key not in self._data:
            return False
        del self._data[key]
        lease_id = self._key_lease.pop(key, None)
        if lease_id is not None and lease_id in self._lease_keys:
            self._lease_keys[lease_id].discard(key)
        self._notify(WatchEvent(WatchEventType.DELETE, key, None))
        return True

    async def _sweep_expired(self) -> None:
        now = self._clock()
        expired = [lid for lid, deadline in self._leases.items() if deadline <= now]
        for lid in expired:
            await self._revoke_locked(lid)

    async def _revoke_locked(self, lease_id: int) -> None:
        self._leases.pop(lease_id, None)
        self._lease_ttl.pop(lease_id, None)
        for key in sorted(self._lease_keys.pop(lease_id, set())):
            self._delete_key_locked(key)

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            try:
                self._reaper = asyncio.get_running_loop().create_task(self._reap_loop())
            except RuntimeError:  # no running loop (sync construction)
                pass

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(self._reap_interval)
            async with self._lock:
                await self._sweep_expired()

    # -- KeyValueStore API -------------------------------------------------

    async def put(self, key: str, value: bytes, lease_id: int | None = None) -> None:
        async with self._lock:
            await self._sweep_expired()
            if lease_id is not None and lease_id not in self._leases:
                raise KeyError(f"unknown or expired lease {lease_id}")
            self._data[key] = value
            old_lease = self._key_lease.pop(key, None)
            if old_lease is not None and old_lease in self._lease_keys:
                self._lease_keys[old_lease].discard(key)
            if lease_id is not None:
                self._key_lease[key] = lease_id
                self._lease_keys.setdefault(lease_id, set()).add(key)
            self._notify(WatchEvent(WatchEventType.PUT, key, value))

    async def put_if_absent(self, key: str, value: bytes, lease_id: int | None = None) -> bool:
        async with self._lock:
            await self._sweep_expired()
            if key in self._data:
                return False
            if lease_id is not None and lease_id not in self._leases:
                raise KeyError(f"unknown or expired lease {lease_id}")
            self._data[key] = value
            if lease_id is not None:
                self._key_lease[key] = lease_id
                self._lease_keys.setdefault(lease_id, set()).add(key)
            self._notify(WatchEvent(WatchEventType.PUT, key, value))
            return True

    async def get(self, key: str) -> bytes | None:
        async with self._lock:
            await self._sweep_expired()
            return self._data.get(key)

    async def get_prefix(self, prefix: str) -> dict[str, bytes]:
        async with self._lock:
            await self._sweep_expired()
            return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    async def delete(self, key: str) -> bool:
        async with self._lock:
            await self._sweep_expired()
            return self._delete_key_locked(key)

    async def create_lease(self, ttl: float = DEFAULT_LEASE_TTL) -> Lease:
        async with self._lock:
            self._ensure_reaper()
            lid = self._lease_next
            self._lease_next += 1
            self._leases[lid] = self._clock() + ttl
            self._lease_ttl[lid] = ttl
            self._lease_keys[lid] = set()
            return Lease(id=lid, ttl=ttl, store=self)

    async def keep_alive(self, lease_id: int) -> None:
        if FAULTS.armed:
            FAULTS.fire("lease.keepalive")
        async with self._lock:
            await self._sweep_expired()
            if lease_id not in self._leases:
                raise KeyError(f"unknown or expired lease {lease_id}")
            self._leases[lease_id] = self._clock() + self._lease_ttl[lease_id]

    async def revoke_lease(self, lease_id: int) -> None:
        async with self._lock:
            await self._revoke_locked(lease_id)

    async def watch_prefix(self, prefix: str, initial: bool = True) -> AsyncIterator[WatchEvent]:
        queue: asyncio.Queue[WatchEvent] = asyncio.Queue()
        async with self._lock:
            await self._sweep_expired()
            snapshot = [(k, v) for k, v in self._data.items() if k.startswith(prefix)] if initial else []
            self._watchers.append((prefix, queue))
        try:
            for k, v in snapshot:
                if FAULTS.armed:
                    FAULTS.fire("store.watch")
                yield WatchEvent(WatchEventType.PUT, k, v)
            while True:
                event = await queue.get()
                if FAULTS.armed:
                    FAULTS.fire("store.watch")
                yield event
        finally:
            self._watchers.remove((prefix, queue))

    async def close(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
            self._reaper = None
