"""KV event + worker load-metrics plane protocol.

Parity: reference `lib/llm/src/kv_router/protocols.rs` — `KvCacheEvent`
(block stored/removed/cleared, tagged with the emitting worker) feeding the
router's radix index, and `ForwardPassMetrics` (the per-worker load snapshot
the scheduler's cost function consumes).

In the TPU build the engine is in-process, so events are emitted directly on
the runtime's event bus (no ZMQ hop as in the reference, SURVEY.md §2 row 25).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class BlockStored:
    block_hash: int
    parent_hash: int | None
    token_ids: tuple[int, ...] = ()


@dataclass(frozen=True)
class BlockRemoved:
    block_hash: int


@dataclass
class KvCacheEvent:
    """One batch of cache mutations from a worker (ordering is meaningful:
    parents are always stored before children)."""

    stored: list[BlockStored] = field(default_factory=list)
    removed: list[BlockRemoved] = field(default_factory=list)
    cleared: bool = False

    def is_empty(self) -> bool:
        return not self.stored and not self.removed and not self.cleared

    def to_dict(self) -> dict[str, Any]:
        return {
            "stored": [
                {"block_hash": s.block_hash, "parent_hash": s.parent_hash, "token_ids": list(s.token_ids)}
                for s in self.stored
            ],
            "removed": [{"block_hash": r.block_hash} for r in self.removed],
            "cleared": self.cleared,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KvCacheEvent":
        return cls(
            stored=[
                BlockStored(s["block_hash"], s.get("parent_hash"), tuple(s.get("token_ids", ())))
                for s in d.get("stored", [])
            ],
            removed=[BlockRemoved(r["block_hash"]) for r in d.get("removed", [])],
            cleared=d.get("cleared", False),
        )


@dataclass
class RouterEvent:
    """A KvCacheEvent tagged with its source worker (instance/lease id)."""

    worker_id: int
    event: KvCacheEvent

    def to_dict(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RouterEvent":
        return cls(worker_id=d["worker_id"], event=KvCacheEvent.from_dict(d["event"]))


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot published on the metrics plane.

    Parity: `kv_router/protocols.rs:43` ForwardPassMetrics.
    """

    worker_id: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    num_requests_waiting: int = 0
    num_requests_running: int = 0
    request_total_slots: int = 1
    cache_hit_rate: float = 0.0
    # Cumulative counters for throughput accounting.
    prompt_tokens_total: int = 0
    generated_tokens_total: int = 0
    # MoE capacity-dispatch routing: cumulative (token, choice) pairs seen
    # and dropped for over-capacity (parallel/moe.py DROP_COUNTER). Zero for
    # dense models and for the dropless/dense dispatches.
    moe_choices_total: int = 0
    moe_dropped_total: int = 0

    @property
    def cache_usage(self) -> float:
        return self.kv_active_blocks / max(self.kv_total_blocks, 1)

    def to_dict(self) -> dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "kv_active_blocks": self.kv_active_blocks,
            "kv_total_blocks": self.kv_total_blocks,
            "num_requests_waiting": self.num_requests_waiting,
            "num_requests_running": self.num_requests_running,
            "request_total_slots": self.request_total_slots,
            "cache_hit_rate": self.cache_hit_rate,
            "prompt_tokens_total": self.prompt_tokens_total,
            "generated_tokens_total": self.generated_tokens_total,
            "moe_choices_total": self.moe_choices_total,
            "moe_dropped_total": self.moe_dropped_total,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ForwardPassMetrics":
        return cls(**{k: d[k] for k in cls().__dict__ if k in d})
