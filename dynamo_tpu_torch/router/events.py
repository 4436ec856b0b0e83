"""KV event plane: worker-side broadcast endpoint + router-side subscriber (a
copy of ``dynamo_tpu/router/events.py``; same endpoint and message shapes).

The engine is in-process (unlike the reference's ZMQ->NATS bridge,
`kv_router/publisher.rs`), so the worker wires its allocator's event callback
straight into a ``KvEventBroadcaster`` served on the worker's ``kv_events``
endpoint. The router discovers worker instances and holds one server-stream
per worker; instance death (lease expiry) removes the worker's blocks from
the index.

A monotonically increasing per-worker sequence number lets subscribers detect
gaps (a reconnect after missed events must resync by clearing that worker).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.protocols.kv import KvCacheEvent, RouterEvent
from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.runtime.component import Endpoint, Instance, instance_prefix
from dynamo_tpu_torch.runtime.discovery import WatchEventType
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

logger = logging.getLogger(__name__)

KV_EVENTS_ENDPOINT = "kv_events"

#: Index reconstructions this process has performed: every snapshot rebase
#: (fresh subscription — including each one a restarted frontend issues) and
#: every gap-forced resync. Sync-on-render source for the frontend's
#: ``dynamo_router_index_resyncs_total`` gauge; the counter being per-process
#: is the point — a bounced frontend proves reconstruction by counting again
#: from zero.
_RESYNCS = 0


def router_resync_snapshot() -> dict:
    return {"resyncs": _RESYNCS}


def _count_resync() -> None:
    global _RESYNCS
    _RESYNCS += 1


class KvEventBroadcaster(AsyncEngine[Any, dict]):
    """Fans the engine's KV events out to any number of stream subscribers.

    Serves the ``kv_events`` endpoint: a subscriber calls ``generate({})`` and
    receives an infinite stream of `{"seq": n, "event": {...}}` messages.
    """

    def __init__(self, snapshot_fn=None) -> None:
        """``snapshot_fn() -> KvCacheEvent`` re-announces current cache
        contents to each new subscriber (reconnect-safe; see allocator
        ``cache_snapshot``)."""
        self._subscribers: set[asyncio.Queue] = set()
        self._seq = 0
        self._snapshot_fn = snapshot_fn
        self._loop: asyncio.AbstractEventLoop | None = None

    def publish(self, event: KvCacheEvent) -> None:
        """Engine-side callback (may be called from the engine's step thread)."""
        if self._loop is None:
            try:
                self._loop = asyncio.get_running_loop()
            except RuntimeError:
                self._loop = None
        msg = {"seq": self._seq, "event": event.to_dict()}
        self._seq += 1
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None and (self._loop is None or running is self._loop):
            # Already on the subscribers' loop: deliver in order, immediately
            # (deferring would let a pre-subscribe event leak into a new
            # subscription after its snapshot).
            self._fanout(msg)
        elif self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._fanout, msg)
        else:
            self._fanout(msg)

    def bind_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def bind_snapshot(self, snapshot_fn) -> None:
        self._snapshot_fn = snapshot_fn

    def _fanout(self, msg: dict) -> None:
        for q in list(self._subscribers):
            q.put_nowait(msg)

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        q: asyncio.Queue = asyncio.Queue()
        self._subscribers.add(q)
        try:
            # First message: a snapshot of everything currently cached, stamped
            # with the subscription's starting sequence number. Seq is read
            # BEFORE the snapshot so an event racing in between is delivered
            # normally afterwards (re-applying stored blocks is idempotent).
            seq0 = self._seq
            snapshot = KvCacheEvent()
            if self._snapshot_fn is not None:
                for _ in range(5):  # engine thread may mutate mid-iteration
                    try:
                        snapshot = self._snapshot_fn()
                        break
                    except RuntimeError:
                        await asyncio.sleep(0.01)
            yield {"seq": seq0, "snapshot": True, "event": snapshot.to_dict()}
            while not context.is_stopped:
                get = asyncio.ensure_future(q.get())
                stop = asyncio.ensure_future(context.wait_stopped())
                try:
                    done, _ = await asyncio.wait({get, stop}, return_when=asyncio.FIRST_COMPLETED)
                finally:
                    # Also when the subscriber closes this stream mid-wait:
                    # neither future may outlive it.
                    get.cancel()
                    stop.cancel()
                if get in done:
                    yield get.result()
                else:
                    return
        finally:
            self._subscribers.discard(q)


class KvEventSubscriber:
    """Router side: one stream per live worker instance, feeding the indexer."""

    def __init__(self, endpoint: Endpoint, indexer: KvIndexer) -> None:
        from dynamo_tpu_torch.config import load_router_resync_settings

        self.endpoint = endpoint
        self.indexer = indexer
        self._resync = load_router_resync_settings()
        self._tasks: dict[int, asyncio.Task] = {}
        self._watch_task: asyncio.Task | None = None

    async def start(self) -> "KvEventSubscriber":
        if self._watch_task is None:
            ep = self.endpoint
            prefix = instance_prefix(ep.namespace, ep.component, ep.name)
            for value in (await ep.runtime.store.get_prefix(prefix)).values():
                self._add(Instance.from_bytes(value))
            self._watch_task = asyncio.create_task(self._watch(prefix))
        return self

    def _add(self, inst: Instance) -> None:
        if inst.instance_id in self._tasks:
            return
        self._tasks[inst.instance_id] = asyncio.create_task(self._consume(inst))

    def _drop(self, worker_id: int) -> None:
        task = self._tasks.pop(worker_id, None)
        if task is not None:
            task.cancel()
        self.indexer.remove_worker(worker_id)

    async def _watch(self, prefix: str) -> None:
        try:
            async for event in self.endpoint.runtime.store.watch_prefix(prefix):
                if event.type is WatchEventType.PUT and event.value is not None:
                    self._add(Instance.from_bytes(event.value))
                elif event.type is WatchEventType.DELETE:
                    self._drop(int(event.key.rsplit(":", 1)[-1], 16))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("kv event instance watch failed")

    async def _consume(self, inst: Instance) -> None:
        wid = inst.instance_id
        transport = self.endpoint.runtime.transport
        backoff = self._resync.backoff_s
        while True:
            expected_seq = 0
            try:
                ctx = Context()
                async for msg in transport.generate(inst.address, {}, ctx):
                    seq = msg.get("seq", expected_seq)
                    if msg.get("snapshot"):
                        # Fresh subscription: rebase our view on the snapshot.
                        # This is the reconstruction path — a restarted
                        # frontend rebuilds its whole prefix index from these.
                        self.indexer.remove_worker(wid)
                        _count_resync()
                        expected_seq = seq
                    elif seq != expected_seq:
                        # Missed events: our view of this worker is stale; the
                        # next reconnect snapshot will rebuild it.
                        logger.warning("kv event gap for worker %x (%d != %d); resync", wid, seq, expected_seq)
                        self.indexer.remove_worker(wid)
                        _count_resync()
                        expected_seq = seq
                    if not msg.get("snapshot"):
                        expected_seq += 1
                    self.indexer.apply_event(RouterEvent(wid, KvCacheEvent.from_dict(msg["event"])))
                    backoff = self._resync.backoff_s
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if wid not in self._tasks:
                    return
                logger.info("kv event stream to %x dropped (%s); retrying", wid, exc)
                self.indexer.remove_worker(wid)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self._resync.max_backoff_s)

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
