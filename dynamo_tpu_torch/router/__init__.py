"""KV-cache-aware request routing (a copy of ``dynamo_tpu/router``).

The router keeps a live world-model of every worker's prefix cache (fed by
the KV event plane) plus load metrics, and schedules each request to the
worker where prefill cost is lowest:

- :mod:`dynamo_tpu_torch.router.indexer` — global block-hash index per worker.
- :mod:`dynamo_tpu_torch.router.scheduler` — cost = overlap-weighted new
  blocks + cache usage + queue depth, softmax-sampled with temperature.
- :mod:`dynamo_tpu_torch.router.events` — worker-side event broadcast
  endpoint + router-side subscriber.
- :mod:`dynamo_tpu_torch.router.metrics` — ForwardPassMetrics publisher/aggregator.
- :mod:`dynamo_tpu_torch.router.router` — KvRouter + the KvPushRouter engine
  that plugs into the frontend pipeline.

The event recorder and the standalone router service are not ported yet.
"""

from dynamo_tpu_torch.router.indexer import KvIndexer, OverlapScores
from dynamo_tpu_torch.router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.router.scheduler import KvScheduler, SchedulerConfig

__all__ = [
    "KvIndexer",
    "OverlapScores",
    "KvScheduler",
    "SchedulerConfig",
    "KvRouter",
    "KvPushRouter",
]
