"""Multi-tier KV block management: G1 (the card's pages) -> G2 (host RAM) ->
G3 (disk), the counterpart of ``dynamo_tpu/blocks/``.

The engine's PageAllocator (``engine/allocator.py``) is the G1 tier. This
package adds the capacity tiers behind it:

- :mod:`dynamo_tpu_torch.blocks.storage` — payload backends: host memory,
  disk (one file per block), and a Null backend (metadata only).
- :mod:`dynamo_tpu_torch.blocks.tier` — a capacity-bounded, LRU-evicting
  pool of completed blocks keyed by sequence hash.
- :mod:`dynamo_tpu_torch.blocks.manager` — the KvBlockManager: write-through
  offload of committed G1 pages into G2 (cascading to G3 on G2 eviction),
  and onboarding — extending a prefill's prefix match by copying blocks back
  into freshly-allocated pages on the card.

Pages cross between the card and the host through the runner's batched
gather and scatter (``TorchModelRunner.read_pages_async``/``write_pages``).
The G4 remote tier (``RemoteStorage``) is not ported: it needs the object
store.
"""

from dynamo_tpu_torch.blocks.manager import BlockManagerConfig, KvBlockManager
from dynamo_tpu_torch.blocks.storage import DiskStorage, HostStorage, NullStorage
from dynamo_tpu_torch.blocks.tier import SharedTierPool, TierPool

__all__ = [
    "KvBlockManager",
    "BlockManagerConfig",
    "TierPool",
    "SharedTierPool",
    "HostStorage",
    "DiskStorage",
    "NullStorage",
]
