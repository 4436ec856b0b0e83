"""Worker load-metrics plane: publisher (worker side) + aggregator (router side)
(a copy of ``dynamo_tpu/router/metrics.py``; same keys and JSON records).

Workers periodically publish their ForwardPassMetrics snapshot into the
discovery store under ``metrics/{namespace}/{component}/{worker_id:x}``,
bound to their lease (stale workers vanish automatically). The aggregator
watches the prefix and keeps an in-memory view the scheduler reads per
request — no scrape round-trip on the request path.

Parity: reference WorkerMetricsPublisher + KvMetricsAggregator
(`kv_router/publisher.rs`, `metrics_aggregator.rs`, `scoring.rs`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable

from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.discovery import WatchEventType

logger = logging.getLogger(__name__)

METRICS_PREFIX = "metrics"


def metrics_key(namespace: str, component: str, worker_id: int) -> str:
    return f"{METRICS_PREFIX}/{namespace}/{component}/{worker_id:x}"


class WorkerMetricsPublisher:
    def __init__(
        self,
        runtime: DistributedRuntime,
        namespace: str,
        component: str,
        worker_id: int,
        snapshot_fn: Callable[[], ForwardPassMetrics],
        *,
        interval: float = 1.0,
        lease=None,
    ) -> None:
        self.runtime = runtime
        self.key = metrics_key(namespace, component, worker_id)
        self.snapshot_fn = snapshot_fn
        self.interval = interval
        self._lease = lease
        self._task: asyncio.Task | None = None

    async def publish_once(self) -> None:
        lease = self._lease or await self.runtime.primary_lease()
        m = self.snapshot_fn()
        await self.runtime.store.put(self.key, json.dumps(m.to_dict()).encode(), lease_id=lease.id)

    async def start(self) -> "WorkerMetricsPublisher":
        if self._task is None:
            await self.publish_once()
            self._task = asyncio.create_task(self._loop())
        return self

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("metrics publish failed")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


class KvMetricsAggregator:
    """Live per-worker metrics view (watch-driven)."""

    def __init__(self, runtime: DistributedRuntime, namespace: str, component: str) -> None:
        self.runtime = runtime
        self.prefix = f"{METRICS_PREFIX}/{namespace}/{component}/"
        self._metrics: dict[int, ForwardPassMetrics] = {}
        self._updated: dict[int, float] = {}  # worker_id -> monotonic of last publish seen
        self._task: asyncio.Task | None = None

    async def start(self) -> "KvMetricsAggregator":
        if self._task is None:
            for key, value in (await self.runtime.store.get_prefix(self.prefix)).items():
                self._apply(key, value)
            self._task = asyncio.create_task(self._watch())
        return self

    def _apply(self, key: str, value: bytes) -> None:
        try:
            wid = int(key[len(self.prefix):], 16)
            self._metrics[wid] = ForwardPassMetrics.from_dict(json.loads(value))
            self._updated[wid] = time.monotonic()
        except Exception:
            logger.exception("bad metrics record at %s", key)

    async def _watch(self) -> None:
        try:
            async for event in self.runtime.store.watch_prefix(self.prefix):
                if event.type is WatchEventType.PUT and event.value is not None:
                    self._apply(event.key, event.value)
                elif event.type is WatchEventType.DELETE:
                    try:
                        wid = int(event.key[len(self.prefix):], 16)
                        self._metrics.pop(wid, None)
                        self._updated.pop(wid, None)
                    except ValueError:
                        pass
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("metrics watch failed")

    def snapshot(self) -> dict[int, ForwardPassMetrics]:
        return dict(self._metrics)

    def staleness_seconds(self) -> dict[int, float]:
        """Seconds since each worker's last ForwardPassMetrics publish was
        seen. A worker whose staleness keeps growing past its publish
        interval is wedged or partitioned — the scheduler is routing on old
        load data for it (surfaced as a frontend gauge)."""
        now = time.monotonic()
        return {wid: max(0.0, now - t) for wid, t in self._updated.items()}

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
