"""KV-aware worker selection: cost function + softmax sampling (a copy of
``dynamo_tpu/router/scheduler.py``).

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

Two optional terms, off (weight 0) by default, when the base cost above is
the whole cost: the attainment term (``DYN_SLO_SCHED``,
``sched.configure_attainment``) adds a worker's predicted TTFT at its load
against the TTFT budget, and the cache-aware term (``DYN_CACHE_AWARE``,
``sched.configure_cache_aware``) adds the seconds of prefill its cache
misses imply. A worker's staleness (seconds since its last load report)
inflates its predicted TTFT and, past ``cache_max_staleness_s``, prices it
as cold.
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
    # Attainment-aware term (dynamo_tpu_torch/sched, DYN_SLO_SCHED): penalize
    # workers whose predicted TTFT at their current load eats into (or
    # blows past) the TTFT budget. 0 disables; ``profile`` must be a
    # planner.core.WorkerProfile for the term to engage (no profile, no
    # prediction — the base cost already spreads load).
    attainment_weight: float = 0.0
    ttft_slo_s: float = 0.5
    profile: object | None = None  # planner.core.WorkerProfile
    # Cache-aware term (DYN_CACHE_AWARE): add each worker's predicted
    # *residual prefill* — the seconds of prefill its cache misses imply,
    # normalized by the TTFT budget — so a worker already holding the
    # request's blocks wins even when base overlap scores near-tie. A
    # worker whose KV-event feed is staler than ``cache_max_staleness_s``
    # is priced as cold — a stale index claims overlap the worker may have
    # evicted, and placement must not chase ghosts. 0 weight disables
    # (bit-identical base cost).
    cache_aware_weight: float = 0.0
    cache_block_tokens: int = 16  # tokens per KV block (engine page_size)
    cache_rate_tokens_per_s: float = 20000.0  # assumed prefill throughput
    cache_max_staleness_s: float = 10.0


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
        *,
        staleness: Mapping[int, float] | None = None,
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
            cost = cfg.overlap_weight * (new_blocks / total) + usage + waiting
            if cfg.attainment_weight > 0 and cfg.profile is not None:
                # Predicted TTFT from the profiler surface at this worker's
                # reported load; stale metrics inflate the prediction (a
                # worker we haven't heard from is *assumed* busier, not
                # idler). ratio < 1 nudges toward slack; the extra
                # max(0, ratio-1) hinge makes predicted SLO misses hurt
                # twice — attainment, not raw latency, is the objective.
                load = (
                    (m.num_requests_running + m.num_requests_waiting)
                    / max(m.request_total_slots, 1)
                ) if m else 0.0
                pred = cfg.profile.ttft_at(min(load, 1.0), pct=99)
                if staleness:
                    pred *= 1.0 + min(staleness.get(wid, 0.0), 10.0)
                ratio = pred / max(cfg.ttft_slo_s, 1e-9)
                cost += cfg.attainment_weight * (ratio + max(0.0, ratio - 1.0))
            if cfg.cache_aware_weight > 0:
                # A worker whose KV-event feed is stale gets priced as cold
                # (full residual): its claimed overlap may be evicted ghosts,
                # and trusting it would *reward* staleness. When every
                # worker is stale the term is a constant and selection falls
                # back to the existing cost ordering.
                stale = (
                    staleness is not None
                    and staleness.get(wid, 0.0) > cfg.cache_max_staleness_s
                )
                eff_new = num_request_blocks if stale else new_blocks
                resid_s = (
                    eff_new * cfg.cache_block_tokens
                    / max(cfg.cache_rate_tokens_per_s, 1e-9)
                )
                cost += cfg.cache_aware_weight * (
                    resid_s / max(cfg.ttft_slo_s, 1e-9)
                )
            out[wid] = cost
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
        *,
        staleness: Mapping[int, float] | None = None,
    ) -> int:
        return self.select(
            self.costs(num_request_blocks, overlaps, metrics, worker_ids, staleness=staleness)
        )
