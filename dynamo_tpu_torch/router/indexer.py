"""Global KV index: which worker holds which cache blocks (a copy of
``dynamo_tpu/router/indexer.py``).

The reference maintains an explicit radix tree over block hashes
(`kv_router/indexer.rs:187-441`). Here the *chained* sequence hash
(``tokens.py``) already encodes the full prefix path in each block hash
— two workers share a hash iff they computed the same prefix — so the tree
collapses to a flat ``hash -> {workers}`` map, and ``find_matches`` walks the
request's hash chain in order, intersecting the live worker set. Same
observable behavior (consecutive-prefix overlap scores), O(1) event
application, trivially correct worker removal.

Events arrive ordered per worker (parents stored before children), tagged
with the emitting worker's instance id (`RouterEvent`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

from dynamo_tpu_torch.protocols.kv import KvCacheEvent, RouterEvent


@dataclass
class OverlapScores:
    """Per-worker count of consecutive leading blocks already cached."""

    scores: dict[int, int] = field(default_factory=dict)

    def best(self) -> tuple[int, int] | None:
        if not self.scores:
            return None
        wid = max(self.scores, key=lambda w: self.scores[w])
        return wid, self.scores[wid]


class KvIndexer:
    def __init__(self, *, ttl_seconds: float | None = None) -> None:
        self._blocks: dict[int, set[int]] = {}  # block_hash -> worker ids
        self._worker_blocks: dict[int, set[int]] = {}  # worker -> block hashes
        self._touched: dict[int, float] = {}  # block_hash -> last match time (expiry)
        self._ttl = ttl_seconds
        self.events_applied = 0
        self._queries = 0

    # -- event plane -------------------------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        wid = event.worker_id
        ev: KvCacheEvent = event.event
        self.events_applied += 1
        if ev.cleared:
            self.remove_worker(wid)
            return
        wb = self._worker_blocks.setdefault(wid, set())
        now = time.monotonic()
        for s in ev.stored:
            self._blocks.setdefault(s.block_hash, set()).add(wid)
            self._touched.setdefault(s.block_hash, now)
            wb.add(s.block_hash)
        for r in ev.removed:
            holders = self._blocks.get(r.block_hash)
            if holders is not None:
                holders.discard(wid)
                if not holders:
                    self._blocks.pop(r.block_hash, None)
                    self._touched.pop(r.block_hash, None)
            wb.discard(r.block_hash)

    def remove_worker(self, worker_id: int) -> None:
        for h in self._worker_blocks.pop(worker_id, ()):  # noqa: B020
            holders = self._blocks.get(h)
            if holders is not None:
                holders.discard(worker_id)
                if not holders:
                    self._blocks.pop(h, None)
                    self._touched.pop(h, None)

    # -- queries -----------------------------------------------------------

    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        """Walk the chain; score[w] = number of leading blocks worker w holds."""
        # Amortized TTL enforcement: no separate maintenance task needed.
        self._queries += 1
        if self._ttl is not None and self._queries % 512 == 0:
            self.expire()
        now = time.monotonic()
        scores: dict[int, int] = {}
        alive: set[int] | None = None
        for i, h in enumerate(block_hashes):
            holders = self._blocks.get(h)
            if not holders:
                break
            self._touched[h] = now
            alive = set(holders) if alive is None else alive & holders
            if not alive:
                break
            for w in alive:
                scores[w] = i + 1
        return OverlapScores(scores)

    def expire(self) -> int:
        """Drop blocks not matched within the TTL (optional memory bound)."""
        if self._ttl is None:
            return 0
        cutoff = time.monotonic() - self._ttl
        stale = [h for h, t in self._touched.items() if t < cutoff]
        for h in stale:
            for w in self._blocks.pop(h, ()):  # noqa: B020
                self._worker_blocks.get(w, set()).discard(h)
            self._touched.pop(h, None)
        return len(stale)

    # -- introspection -----------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def worker_block_counts(self) -> dict[int, int]:
        return {w: len(b) for w, b in self._worker_blocks.items()}
