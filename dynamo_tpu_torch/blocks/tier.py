"""A capacity-bounded pool of completed KV blocks with LRU eviction
(``dynamo_tpu/blocks/tier.py``).

Each tier (G2 host, G3 disk) is one TierPool over a storage backend. On
insert beyond capacity the least-recently-used block is evicted and handed to
``on_evict`` — which the manager uses to cascade G2 evictions into G3.

Parity: reference per-tier BlockPool with priority eviction
(`block_manager/pool.rs:156`, `pool/priority_key.rs`): our priority key is
(priority, lru-order) — lower priority evicts first, ties by recency.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from dynamo_tpu_torch.blocks.storage import BlockStorage, Payload

logger = logging.getLogger(__name__)


@dataclass
class TierStats:
    capacity: int
    used: int
    hits: int
    misses: int
    evictions: int


class TierPool:
    def __init__(
        self,
        name: str,
        storage: BlockStorage,
        capacity_blocks: int,
        *,
        on_evict: Callable[[int, Payload | None], None] | None = None,
    ) -> None:
        self.name = name
        self.storage = storage
        self.capacity = capacity_blocks
        self.on_evict = on_evict
        self._lru: OrderedDict[int, int] = OrderedDict()  # block_hash -> priority
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._lru

    def has_local(self, block_hash: int) -> bool:
        """Membership in this tier's own (in-memory) index only — shared
        tiers additionally consult the backend in ``__contains__``."""
        return block_hash in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    def put(self, block_hash: int, payload: Payload, *, priority: int = 0) -> None:
        """Insert (or refresh) a block; evicts LRU/low-priority past capacity."""
        if self.capacity <= 0:
            return
        if block_hash in self._lru:
            self._lru.move_to_end(block_hash)
            return
        while len(self._lru) >= self.capacity:
            self._evict_one()
        self.storage.write(block_hash, payload)
        self._lru[block_hash] = priority

    def _evict_one(self) -> None:
        # Lowest priority first; among equals, least recently used (front).
        victim = min(self._lru, key=lambda h: self._lru[h])
        lowest = self._lru[victim]
        for h, p in self._lru.items():  # first (= oldest) with lowest priority
            if p == lowest:
                victim = h
                break
        self._lru.pop(victim)
        # Only fetch the payload when someone will receive it — for a
        # terminal tier (no cascade) the read would be a pure waste, and on
        # a remote backend a full round-trip per eviction.
        payload = self.storage.read(victim) if self.on_evict is not None else None
        self.storage.delete(victim)
        self._evictions += 1
        if self.on_evict is not None:
            self.on_evict(victim, payload)

    def get(self, block_hash: int) -> Payload | None:
        """Fetch a block's payload (touches LRU). None on miss or lost payload."""
        if block_hash not in self._lru:
            self._misses += 1
            return None
        payload = self.storage.read(block_hash)
        if payload is None:  # metadata-only backend or lost file
            self._lru.pop(block_hash, None)
            self._misses += 1
            return None
        self._lru.move_to_end(block_hash)
        self._hits += 1
        return payload

    def remove(self, block_hash: int) -> None:
        if self._lru.pop(block_hash, None) is not None:
            self.storage.delete(block_hash)

    def clear(self) -> int:
        n = len(self._lru)
        for h in list(self._lru):
            self.remove(h)
        return n

    def stats(self) -> TierStats:
        return TierStats(
            capacity=self.capacity,
            used=len(self._lru),
            hits=self._hits,
            misses=self._misses,
            evictions=self._evictions,
        )


class SharedTierPool(TierPool):
    """A tier whose backend is shared between workers (the G4 object store).

    Local LRU state tracks only **this worker's own writes** (capacity
    applies to what we put there); membership and reads additionally fall
    through to the backend, so blocks offloaded by *other* workers are
    discoverable and onboardable. Semantics are a best-effort shared cache:
    a peer enforcing its own capacity may delete a block between our probe
    and fetch — readers must (and do) treat a None payload as a miss.
    """

    _degraded = False  # log-once latch: probes run per block on the request path

    def _note_failure(self, what: str) -> None:
        if not self._degraded:
            self._degraded = True
            logger.warning("shared tier %s degraded: %s failed (reads as misses "
                           "until the backend recovers)", self.name, what, exc_info=True)

    def _note_success(self) -> None:
        if self._degraded:
            self._degraded = False
            logger.info("shared tier %s recovered", self.name)

    def __contains__(self, block_hash: int) -> bool:
        if self.has_local(block_hash):
            return True
        exists = getattr(self.storage, "exists", None)
        if exists is None:
            return False
        try:
            hit = bool(exists(block_hash))
        except Exception:
            # A degraded remote tier must read as a miss, never break the
            # engine step that's probing it.
            self._note_failure("membership probe")
            return False
        self._note_success()
        return hit

    def get(self, block_hash: int) -> Payload | None:
        if self.has_local(block_hash):
            return super().get(block_hash)
        try:
            payload = self.storage.read(block_hash)  # a peer's block
            self._note_success()
        except Exception:
            self._note_failure("remote read")
            payload = None
        if payload is None:
            self._misses += 1
            return None
        self._hits += 1
        return payload
