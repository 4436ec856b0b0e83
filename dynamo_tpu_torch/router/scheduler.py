"""KV-aware worker selection: cost function + softmax sampling (a copy of
``dynamo_tpu/router/scheduler.py`` without its SLO terms).

Cost per candidate worker (parity with reference `kv_router/scheduler.rs:298-360`):

    cost(w) = overlap_weight * new_blocks(w) / total_blocks
            + cache_usage(w)
            + waiting(w) / slots(w)

``new_blocks`` is the prefill work this worker would actually do after its
cached overlap; usage and queue depth keep load spread. Selection is softmax
over ``-cost / temperature`` (temperature 0 => deterministic argmin), which
probabilistically spreads near-ties instead of thundering-herding the single
best worker. (The JAX build's pluggable ``WorkerSelector`` hook is not
ported: no caller of the port sets one.)

The JAX build's attainment and cache-aware cost terms (``DYN_SLO_SCHED``,
``DYN_CACHE_AWARE``) need the SLO scheduler, which is not ported yet: their
``SchedulerConfig`` fields are left out, so passing one fails with a
``TypeError`` that names it, and ``build_kv_router`` refuses the flags. With
them off, the JAX build's costs are these costs, bit for bit; the
staleness those terms read is not taken.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Mapping

from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics
from dynamo_tpu_torch.router.indexer import OverlapScores


@dataclass
class SchedulerConfig:
    overlap_weight: float = 1.0
    temperature: float = 0.0  # 0 => argmin cost
    seed: int | None = None


class KvScheduler:
    def __init__(self, config: SchedulerConfig | None = None) -> None:
        self.config = config or SchedulerConfig()
        self._rng = random.Random(self.config.seed)

    def costs(
        self,
        num_request_blocks: int,
        overlaps: OverlapScores,
        metrics: Mapping[int, ForwardPassMetrics],
        worker_ids: list[int],
    ) -> dict[int, float]:
        total = max(num_request_blocks, 1)
        cfg = self.config
        out: dict[int, float] = {}
        for wid in worker_ids:
            overlap = min(overlaps.scores.get(wid, 0), num_request_blocks)
            new_blocks = num_request_blocks - overlap
            m = metrics.get(wid)
            usage = m.cache_usage if m else 0.0
            waiting = (m.num_requests_waiting / max(m.request_total_slots, 1)) if m else 0.0
            out[wid] = cfg.overlap_weight * (new_blocks / total) + usage + waiting
        return out

    def select(self, costs: dict[int, float]) -> int:
        if not costs:
            raise ValueError("no candidate workers")
        if self.config.temperature <= 0:
            best = min(costs.values())
            # Deterministic tie-break on lowest id for reproducibility.
            return min(w for w, c in costs.items() if c == best)
        ids = list(costs)
        logits = [-costs[w] / self.config.temperature for w in ids]
        mx = max(logits)
        weights = [math.exp(l - mx) for l in logits]
        return self._rng.choices(ids, weights=weights, k=1)[0]

    def schedule(
        self,
        num_request_blocks: int,
        overlaps: OverlapScores,
        metrics: Mapping[int, ForwardPassMetrics],
        worker_ids: list[int],
    ) -> int:
        return self.select(self.costs(num_request_blocks, overlaps, metrics, worker_ids))
