"""KvBlockManager: ties the capacity tiers to the engine's G1 pages
(``dynamo_tpu/blocks/manager.py``, less the G4 remote tier: it needs the
object store, which is not ported yet, so ``g4_capacity_blocks > 0`` raises).

Flow (parity: reference OffloadManager `offload.rs:80` + onboarding):

- **Offload (write-through):** when a G1 page fills and commits to the
  prefix cache, its payload is copied device->host into G2. A G2 eviction
  cascades the payload into G3 (disk). G1 eviction then never loses data
  that was worth keeping.
- **Onboard:** at admission, after the G1 prefix match stops, the manager is
  asked for the *next* blocks in the chain; hits are copied back into
  freshly-allocated G1 pages, extending the cached prefix and shrinking
  prefill compute.

Device access is through callables injected by the engine runner
(``read_page(page_id) -> (k, v)``, ``write_page(page_id, k, v)``, the batched
``write_pages`` and, at offload, ``read_pages``/``read_pages_async``), keeping
this module free of torch so tier logic unit-tests run instantly.
"""

from __future__ import annotations

import logging
import os
import pathlib
import tempfile
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from dynamo_tpu_torch.blocks.storage import DiskStorage, HostStorage, NullStorage, Payload
from dynamo_tpu_torch.blocks.tier import TierPool

logger = logging.getLogger(__name__)

ReadPage = Callable[[int], Payload]
WritePage = Callable[[int, np.ndarray, np.ndarray], None]
WritePages = Callable[[list, list, list], None]


@dataclass
class BlockManagerConfig:
    g2_capacity_blocks: int = 1024
    g3_capacity_blocks: int = 0  # 0 disables the disk tier
    g3_path: str | pathlib.Path = os.path.join(tempfile.gettempdir(), "dynamo_tpu_torch_g3")
    g4_capacity_blocks: int = 0  # the remote (object-store) tier: not ported, must stay 0
    onboard_limit: int = 64  # max blocks copied back per admission
    null_storage: bool = False  # CI: capacity logic without payload memory


class KvBlockManager:
    def __init__(
        self,
        config: BlockManagerConfig,
        *,
        read_page: ReadPage,
        write_page: WritePage,
        write_pages: WritePages | None = None,
        g2_storage=None,
    ) -> None:
        self.config = config
        self._read_page = read_page
        self._write_page = write_page
        self._write_pages = write_pages
        # Tier metadata + storage ops are guarded per block: the async
        # onboarding session fetches payloads from a background thread while
        # the engine thread offloads freshly committed pages into the same
        # pools. Per-block granularity keeps a slow G3 read from gating
        # flush_offloads (and thus the next engine step) for a whole fetch.
        self._lock = threading.RLock()

        if config.g4_capacity_blocks > 0:
            raise NotImplementedError(
                "g4_capacity_blocks: the G4 remote tier needs the object store, which is not ported to "
                "dynamo_tpu_torch yet"
            )
        self.g3: TierPool | None = None
        if config.g3_capacity_blocks > 0:
            g3_storage = NullStorage() if config.null_storage else DiskStorage(config.g3_path)
            self.g3 = TierPool("g3", g3_storage, config.g3_capacity_blocks)

        def cascade(block_hash: int, payload: Payload | None) -> None:
            if payload is not None and self.g3 is not None:
                self.g3.put(block_hash, payload)

        if g2_storage is None:
            g2_storage = NullStorage() if config.null_storage else HostStorage()
        self.g2 = TierPool("g2", g2_storage, config.g2_capacity_blocks, on_evict=cascade)
        self.offloaded = 0
        self.onboarded = 0

    @property
    def _tiers(self) -> list[TierPool]:
        return [t for t in (self.g2, self.g3) if t is not None]

    # -- offload path ------------------------------------------------------

    def offload(self, block_hash: int, page_id: int) -> None:
        """Write-through one committed G1 page into G2 (no-op if present)."""
        self.offload_batch([(block_hash, page_id)])

    def offload_batch(self, items: list[tuple[int, int]], *, read_pages=None,
                      read_pages_async=None) -> None:
        """Write-through many (block_hash, page_id) pairs at once.

        With ``read_pages`` (``list[page_id] -> list[Payload]``) the device
        reads collapse into one batched gather + one device->host transfer;
        otherwise falls back to per-page reads. ``read_pages_async``
        (``list[page_id] -> handle`` with ``wait() -> list[Payload]``) is
        preferred over both: the gather is dispatched and its device->host
        DMA kicked off immediately, and this thread only blocks at the tier
        puts — the copy overlaps whatever the engine does in between.
        """
        todo: list[tuple[int, int]] = []
        seen: set[int] = set()
        with self._lock:
            for block_hash, page_id in items:
                # Dedup against LOCAL membership (the JAX build's rule: a
                # shared tier's full probe would be a remote round trip).
                if block_hash in seen or any(tier.has_local(block_hash) for tier in self._tiers):
                    continue
                seen.add(block_hash)
                todo.append((block_hash, page_id))
        if not todo:
            return
        if read_pages_async is not None:
            payloads = read_pages_async([p for _, p in todo]).wait()
        elif read_pages is not None:
            payloads = read_pages([p for _, p in todo])
        else:
            payloads = [self._read_page(p) for _, p in todo]
        for (block_hash, _), payload in zip(todo, payloads):
            with self._lock:
                self.g2.put(block_hash, payload)
            self.offloaded += 1

    # -- onboard path ------------------------------------------------------

    def lookup(self, block_hash: int) -> Payload | None:
        """G2 first, then G3 (a G3 hit promotes back into G2)."""
        with self._lock:
            return self._lookup_tiered(block_hash)[0]

    def _lookup_tiered(self, block_hash: int) -> tuple[Payload | None, str]:
        payload = self.g2.get(block_hash)
        if payload is not None:
            return payload, "g2"
        if self.g3 is not None:
            payload = self.g3.get(block_hash)
            if payload is not None:
                self.g2.put(block_hash, payload)
                return payload, "g3"
        return None, ""

    def probe_prefix(self, block_hashes: list[int], start: int) -> int:
        """How many consecutive blocks from ``start`` the tiers hold.

        Membership-only — no payload I/O. Admission uses this to budget and
        allocate pages first; payloads are fetched only once pages exist
        (otherwise each failed admission attempt would re-read from disk).
        """
        n = 0
        with self._lock:
            for h in block_hashes[start:]:
                if n >= self.config.onboard_limit:
                    break
                if any(h in tier for tier in self._tiers):
                    n += 1
                else:
                    break
        return n

    def fetch_prefix(self, block_hashes: list[int], start: int, count: int) -> list[Payload]:
        """Read up to ``count`` consecutive payloads; may return fewer if a
        block was evicted (or its payload lost) since the probe."""
        return self.fetch_prefix_tiered(block_hashes, start, count)[0]

    def fetch_prefix_tiered(
        self, block_hashes: list[int], start: int, count: int
    ) -> tuple[list[Payload], list[str]]:
        """``fetch_prefix`` plus the tier each payload came from.

        The async onboarding session runs this off the engine thread; the
        per-block lock in ``_lookup_tiered`` is what makes that safe against
        concurrent offloads. Tier names feed the per-tier onboard metrics."""
        payloads: list[Payload] = []
        tiers: list[str] = []
        for h in block_hashes[start : start + count]:
            with self._lock:
                payload, tier = self._lookup_tiered(h)
            if payload is None:
                break
            payloads.append(payload)
            tiers.append(tier)
        return payloads, tiers

    def onboard(self, page_ids: list[int], payloads: list[Payload]) -> None:
        """Copy payloads host->device into the given (freshly-allocated) pages.

        With a batched writer wired (``ModelRunner.write_pages``) N pages cost
        one transfer + one scatter dispatch; the per-page path is the fallback
        for runners without it."""
        if not payloads:
            return
        if self._write_pages is not None and len(payloads) > 1:
            pids = list(page_ids[: len(payloads)])
            self._write_pages(pids, [k for k, _ in payloads], [v for _, v in payloads])
        else:
            for pid, (k, v) in zip(page_ids, payloads):
                self._write_page(pid, k, v)
        self.onboarded += len(payloads)

    # -- admin -------------------------------------------------------------

    def clear(self) -> int:
        with self._lock:
            return sum(tier.clear() for tier in self._tiers)

    def stats(self) -> dict:
        out = {"g2": self.g2.stats().__dict__, "offloaded": self.offloaded, "onboarded": self.onboarded}
        if self.g3 is not None:
            out["g3"] = self.g3.stats().__dict__
        return out
