"""KvRouter: ties indexer + scheduler + metrics into a routing engine (a copy of
``dynamo_tpu/router/router.py``).

``KvPushRouter`` is the pipeline stage the frontend uses in ``kv`` router
mode: for each PreprocessedRequest it computes the prompt's chained block
hashes, asks the indexer for per-worker overlaps, scores candidates with the
scheduler, and opens the stream *direct* to the chosen worker instance.

The hashes are ``tokens.compute_block_hashes`` under the engine's salt, the
ones the worker's page allocator publishes as it commits pages; if the two
disagreed, every overlap would be 0 and routing would be blind without any
error.

Parity: reference `kv_router.rs:104-199,220` (KvRouter + KvPushRouter).
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.router.events import KV_EVENTS_ENDPOINT, KvEventSubscriber
from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.metrics import KvMetricsAggregator
from dynamo_tpu_torch.router.scheduler import KvScheduler, SchedulerConfig
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.tokens import DEFAULT_SALT, compute_block_hashes, mm_salt_fold
from dynamo_tpu_torch.tracing import Span, trace_of

logger = logging.getLogger(__name__)

class KvRouter:
    """Scheduling brain: returns the best worker for a token sequence."""

    def __init__(
        self,
        indexer: KvIndexer,
        scheduler: KvScheduler,
        aggregator: KvMetricsAggregator | None,
        *,
        block_size: int,
        salt: int | None = None,
    ) -> None:
        self.indexer = indexer
        self.scheduler = scheduler
        self.aggregator = aggregator
        self.block_size = block_size
        self.salt = salt

    def schedule(self, token_ids: list[int], worker_ids: list[int], *, salt_fold: int = 0) -> tuple[int, int]:
        """Returns (worker_id, overlap_blocks) for the given prompt.

        ``salt_fold``: multimodal content hash (tokens.mm_salt_fold) so the
        lookup hashes match what the serving engine published."""
        base = self.salt if self.salt is not None else DEFAULT_SALT
        hashes = compute_block_hashes(token_ids, self.block_size, salt=base ^ salt_fold)
        overlaps = self.indexer.find_matches(hashes)
        metrics = self.aggregator.snapshot() if self.aggregator else {}
        stale = self.aggregator.staleness_seconds() if self.aggregator else None
        num_blocks = max(len(hashes), 1)
        wid = self.scheduler.schedule(num_blocks, overlaps, metrics, worker_ids, staleness=stale)
        return wid, overlaps.scores.get(wid, 0)


class KvPushRouter(AsyncEngine[Any, Any]):
    """Pipeline stage: route each request to its best worker, then go direct."""

    def __init__(self, client: Client, router: KvRouter) -> None:
        self.client = client
        self.router = router

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        body = request if isinstance(request, dict) else request.to_dict()
        token_ids = list(body.get("token_ids", []))
        await self.client.start()
        worker_ids = self.client.instance_ids()
        if not worker_ids:
            worker_ids = [i.instance_id for i in await self.client.wait_for_instances(count=1)]
        with Span(
            "router_decision", trace=trace_of(context), request_id=context.id,
            candidates=len(worker_ids),
        ) as span:
            wid, overlap = self.router.schedule(
                token_ids, worker_ids, salt_fold=mm_salt_fold(body.get("mm_inputs"))
            )
            span.fields["worker"] = f"{wid:x}"
            span.fields["overlap_blocks"] = overlap
        logger.debug("kv-routed %d tokens -> worker %x (overlap %d blocks)", len(token_ids), wid, overlap)
        async for item in self.client.generate(body, context, instance_id=wid):
            yield item


async def build_kv_router(
    runtime: DistributedRuntime,
    *,
    namespace: str,
    component: str,
    endpoint: str = "generate",
    block_size: int,
) -> tuple[KvPushRouter, KvEventSubscriber, KvMetricsAggregator]:
    """Assemble the full KV routing stack against a worker component. The
    scheduler takes the SLO attainment term (a no-op unless ``DYN_SLO_SCHED``
    is on) and the cache-aware residual term (a no-op unless
    ``DYN_CACHE_AWARE`` is on) from the environment."""
    from dynamo_tpu_torch.sched import configure_attainment, configure_cache_aware

    indexer = KvIndexer()
    events_ep = runtime.namespace(namespace).component(component).endpoint(KV_EVENTS_ENDPOINT)
    subscriber = await KvEventSubscriber(events_ep, indexer).start()
    aggregator = await KvMetricsAggregator(runtime, namespace, component).start()
    scheduler_config = SchedulerConfig()
    configure_attainment(scheduler_config)
    configure_cache_aware(scheduler_config, block_tokens=block_size)
    router = KvRouter(indexer, KvScheduler(scheduler_config), aggregator, block_size=block_size)
    client = runtime.namespace(namespace).component(component).endpoint(endpoint).client(router_mode="direct")
    return KvPushRouter(client, router), subscriber, aggregator
