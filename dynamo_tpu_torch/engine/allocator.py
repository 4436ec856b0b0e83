"""HBM page allocator: free list + refcounted prefix cache + LRU eviction.

This is the G1 (device) tier of the multi-tier KV block system. Pages hold
``page_size`` tokens of KV for all layers. Completed pages gain a chained
block hash (`dynamo_tpu.tokens`) and stay resident after release as prefix
cache until evicted by demand, LRU-first — at which point a "removed" KV
event is emitted so the global router index stays truthful.

Parity: reference block manager G1 pool + registry
(`lib/llm/src/block_manager/pool.rs:156`, `block/registry.rs`) and the KV
event contract of `kv_router/publisher.rs`. Design is fresh: a flat
page-table keyed by integer page id matching the Pallas kernel's block-table
format, no typestate machinery — mutability is guarded by refcounts.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Sequence

from dynamo_tpu_torch.protocols.kv import BlockRemoved, BlockStored, KvCacheEvent

EventCallback = Callable[[KvCacheEvent], None]


class OutOfPagesError(RuntimeError):
    pass


@dataclass
class _PageInfo:
    refcount: int = 0
    block_hash: int | None = None  # set once the page's block is complete
    parent_hash: int | None = None
    is_cache_holder: bool = False  # this page backs the prefix-cache entry for its hash


@dataclass
class AllocatorStats:
    total_pages: int = 0
    free_pages: int = 0
    cached_pages: int = 0  # evictable (refcount 0, hash registered)
    active_pages: int = 0  # referenced by live sequences
    hits: int = 0
    misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PageAllocator:
    """Allocator over pages ``1..num_pages-1`` (page 0 is the reserved null page)."""

    def __init__(self, num_pages: int, page_size: int, *, on_event: EventCallback | None = None) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._on_event = on_event
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields low ids first
        self._pages: dict[int, _PageInfo] = {}
        self._cached: dict[int, int] = {}  # block_hash -> page_id (complete, reusable)
        self._lru: OrderedDict[int, None] = OrderedDict()  # evictable page ids, LRU first
        self._hits = 0
        self._misses = 0

    # -- events ------------------------------------------------------------

    def _emit(self, event: KvCacheEvent) -> None:
        if self._on_event is not None and not event.is_empty():
            self._on_event(event)

    # -- queries -----------------------------------------------------------

    def num_free(self) -> int:
        """Pages allocatable right now (free list + evictable cache)."""
        return len(self._free) + len(self._lru)

    def stats(self) -> AllocatorStats:
        active = sum(1 for p in self._pages.values() if p.refcount > 0)
        return AllocatorStats(
            total_pages=self.num_pages - 1,
            free_pages=len(self._free),
            cached_pages=len(self._lru),
            active_pages=active,
            hits=self._hits,
            misses=self._misses,
        )

    # -- allocation --------------------------------------------------------

    def allocate(self, n: int = 1) -> list[int]:
        """Take ``n`` fresh pages (evicting prefix cache LRU-first if needed)."""
        if self.num_free() < n:
            raise OutOfPagesError(f"need {n} pages, have {self.num_free()}")
        out: list[int] = []
        removed: list[BlockRemoved] = []
        for _ in range(n):
            if self._free:
                pid = self._free.pop()
            else:
                pid, _ = self._lru.popitem(last=False)  # least recently used
                info = self._pages[pid]
                assert info.refcount == 0 and info.block_hash is not None
                if info.is_cache_holder:
                    self._cached.pop(info.block_hash, None)
                    removed.append(BlockRemoved(info.block_hash))
            self._pages[pid] = _PageInfo(refcount=1)
            out.append(pid)
        self._emit(KvCacheEvent(removed=removed))
        return out

    def match_prefix(self, block_hashes: Sequence[int]) -> list[int]:
        """Longest cached prefix: acquire and return its pages (refcount++).

        Touches matched pages to MRU. Stops at the first miss — hash chaining
        means later matches without the prefix would be a different sequence.
        """
        matched: list[int] = []
        for h in block_hashes:
            pid = self._cached.get(h)
            if pid is None:
                self._misses += 1
                break
            info = self._pages[pid]
            if info.refcount == 0:
                self._lru.pop(pid, None)
            info.refcount += 1
            matched.append(pid)
            self._hits += 1
        return matched

    def peek_prefix(self, block_hashes: Sequence[int]) -> int:
        """Longest cached prefix length WITHOUT acquiring.

        No refcount, MRU, or hit/miss effects: the admission plane's
        residual-cost estimate runs this over every waiting sequence each
        prepare(), and pricing must not perturb eviction order or pin pages
        the request may never be admitted to use."""
        n = 0
        for h in block_hashes:
            if h not in self._cached:
                break
            n += 1
        return n

    def acquire(self, page_id: int) -> None:
        """Add a reference to an already-allocated page (e.g. fork/beam)."""
        info = self._pages[page_id]
        if info.refcount == 0:
            self._lru.pop(page_id, None)
        info.refcount += 1

    # -- completion / release ---------------------------------------------

    def commit(self, page_id: int, block_hash: int, parent_hash: int | None, token_ids: Sequence[int] = ()) -> bool:
        """Mark a page's block complete and publish it to the prefix cache.

        Returns True if this page became the cache holder for its hash. If
        the hash is already cached (another sequence computed the same block
        concurrently), this page stays un-cached — a duplicate that simply
        frees on release.
        """
        info = self._pages[page_id]
        if info.block_hash is not None:
            return False  # already committed
        info.block_hash = block_hash
        info.parent_hash = parent_hash
        if block_hash not in self._cached:
            self._cached[block_hash] = page_id
            info.is_cache_holder = True
            self._emit(KvCacheEvent(stored=[BlockStored(block_hash, parent_hash, tuple(token_ids))]))
            return True
        return False

    def release(self, page_ids: Sequence[int]) -> None:
        """Drop one reference from each page; refcount-0 pages become evictable
        prefix cache (if committed + cache holder) or return to the free list."""
        for pid in page_ids:
            info = self._pages[pid]
            if info.refcount <= 0:
                raise ValueError(f"double release of page {pid}")
            info.refcount -= 1
            if info.refcount == 0:
                if info.is_cache_holder:
                    self._lru[pid] = None  # becomes MRU end
                    self._lru.move_to_end(pid)
                else:
                    del self._pages[pid]
                    self._free.append(pid)

    def page_parent_hash(self, page_id: int) -> int | None:
        """Parent hash recorded for a committed page (transfer metadata)."""
        return self._pages[page_id].parent_hash

    def acquire_cached(self, block_hash: int) -> int | None:
        """Pin the cached page backing this hash (refcount++), if present.

        Deliberately the only hit-check: pinning means the page can't be
        evicted by a later :meth:`allocate` — required when checking hits
        while also allocating in the same pass (KV transfer injection)."""
        pid = self._cached.get(block_hash)
        if pid is None:
            return None
        self.acquire(pid)
        return pid

    def cache_snapshot(self) -> KvCacheEvent:
        """All currently-known completed blocks, parents before children.

        Used to (re)announce this worker's cache to a fresh event subscriber
        (router reconnect / late join).
        """
        blocks = {
            info.block_hash: info.parent_hash
            for info in self._pages.values()
            if info.block_hash is not None and info.is_cache_holder
        }
        stored: list[BlockStored] = []
        emitted: set[int] = set()
        pending = dict(blocks)
        while pending:
            progress = False
            for h, parent in list(pending.items()):
                if parent is None or parent in emitted or parent not in blocks:
                    stored.append(BlockStored(h, parent))
                    emitted.add(h)
                    del pending[h]
                    progress = True
            if not progress:  # pragma: no cover - cycles are impossible by construction
                break
        return KvCacheEvent(stored=stored)

    def clear_cache(self) -> int:
        """Drop all evictable prefix-cache pages (the clear-kv-blocks admin op).
        Returns the number of pages freed."""
        removed: list[BlockRemoved] = []
        n = 0
        while self._lru:
            pid, _ = self._lru.popitem(last=False)
            info = self._pages.pop(pid)
            if info.is_cache_holder and info.block_hash is not None:
                self._cached.pop(info.block_hash, None)
                removed.append(BlockRemoved(info.block_hash))
            self._free.append(pid)
            n += 1
        self._emit(KvCacheEvent(removed=removed))
        return n
