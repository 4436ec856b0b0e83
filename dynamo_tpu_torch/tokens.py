"""Token sequences and chained block hashing — the canonical prefix-cache identity.

Every KV-cache block in the system (engine paged cache, block manager tiers,
router radix index) is identified by a *sequence hash*: a chained xxh3-64 over
the block's tokens and the parent block's sequence hash. Two workers that have
processed the same prefix therefore derive the same block identities with no
coordination, which is what makes global KV-aware routing and cross-worker KV
reuse possible.

A copy of ``dynamo_tpu/tokens.py`` without its native-extension fast path:
the hashes are ``xxhash.xxh3_64`` exactly as there, so block identities (and
the KV events and router lookups keyed on them) agree across the two builds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import xxhash

# Salt mixed into every block hash so sequence hashes are namespaced to this
# framework's cache-identity scheme (mirrors the reference's hash salt).
DEFAULT_SALT: int = 0xD1A2_0001


def mm_salt_fold(mm_inputs) -> int:
    """Content hash folded into block-hash salts for multimodal requests.

    Identical prompts with different images must have different prefix-cache
    identities; the engine AND the KV router must fold the same value or the
    router's overlap lookups never match the worker's published hashes."""
    if not mm_inputs or not isinstance(mm_inputs, dict):
        return 0
    import hashlib

    payload = str(mm_inputs.get("embeds_b64") or "").encode()
    return int.from_bytes(hashlib.blake2b(payload, digest_size=8).digest(), "big")

_U64 = np.dtype("<u8")
_I32 = np.dtype("<i4")


def _hash_bytes(data: bytes, seed: int) -> int:
    return xxhash.xxh3_64_intdigest(data, seed=seed)


def hash_token_block(tokens: Sequence[int] | np.ndarray, parent_hash: int | None, *, salt: int = DEFAULT_SALT) -> int:
    """Chained hash of one block: xxh3(parent_hash_le8 || tokens_le4, seed=salt).

    ``parent_hash=None`` marks the root block (no parent bytes are mixed in,
    so a sequence's first block hash depends only on its tokens + salt).
    """
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.uint32), dtype=_I32)
    if parent_hash is None:
        payload = arr.tobytes()
    else:
        payload = np.uint64(parent_hash).astype(_U64).tobytes() + arr.tobytes()
    return _hash_bytes(payload, seed=salt)


def compute_block_hashes(
    tokens: Sequence[int] | np.ndarray,
    block_size: int,
    *,
    salt: int = DEFAULT_SALT,
) -> list[int]:
    """Sequence hashes for every *complete* block of ``tokens``.

    The trailing partial block (``len(tokens) % block_size`` tokens) has no
    identity yet and is excluded — identical to how the engine only publishes
    KV events for full blocks.
    """
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    arr = np.asarray(tokens, dtype=np.uint32)
    n_full = len(arr) // block_size
    hashes: list[int] = []
    parent: int | None = None
    for i in range(n_full):
        h = hash_token_block(arr[i * block_size : (i + 1) * block_size], parent, salt=salt)
        hashes.append(h)
        parent = h
    return hashes


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete block of ``block_size`` tokens with its chained identity."""

    tokens: tuple[int, ...]
    block_hash: int
    parent_hash: int | None
    position: int  # block index within the sequence

    @property
    def block_size(self) -> int:
        return len(self.tokens)


class TokenBlockSequence:
    """A token stream chunked into hash-chained blocks, supporting incremental append.

    Used by the engine scheduler to derive block identities as a request's
    sequence grows during decode: each time the partial tail fills a block, the
    block is committed, gains a sequence hash, and (at the engine layer) a KV
    "stored" event is emitted for it.
    """

    def __init__(
        self,
        tokens: Sequence[int] | np.ndarray | None = None,
        *,
        block_size: int,
        salt: int = DEFAULT_SALT,
    ) -> None:
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.salt = salt
        self._blocks: list[TokenBlock] = []
        self._partial: list[int] = []
        if tokens is not None:
            self.extend(tokens)

    # -- growth ------------------------------------------------------------

    def append(self, token: int) -> TokenBlock | None:
        """Append one token; returns the newly-committed block if the tail filled."""
        self._partial.append(int(token))
        if len(self._partial) == self.block_size:
            return self._commit_partial()
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all blocks committed as a result."""
        committed: list[TokenBlock] = []
        for t in tokens:
            blk = self.append(int(t))
            if blk is not None:
                committed.append(blk)
        return committed

    def _commit_partial(self) -> TokenBlock:
        parent = self._blocks[-1].block_hash if self._blocks else None
        h = hash_token_block(self._partial, parent, salt=self.salt)
        blk = TokenBlock(
            tokens=tuple(self._partial),
            block_hash=h,
            parent_hash=parent,
            position=len(self._blocks),
        )
        self._blocks.append(blk)
        self._partial = []
        return blk

    # -- truncation (sequence rewind, e.g. on preemption/restart) ----------

    def truncate(self, num_tokens: int) -> None:
        """Rewind the sequence to its first ``num_tokens`` tokens."""
        if num_tokens > len(self):
            raise ValueError(f"cannot truncate to {num_tokens}, sequence has {len(self)}")
        all_tokens = self.tokens
        self._blocks = []
        self._partial = []
        self.extend(all_tokens[:num_tokens])

    # -- views -------------------------------------------------------------

    @property
    def blocks(self) -> list[TokenBlock]:
        return list(self._blocks)

    @property
    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self._blocks]

    @property
    def partial_tokens(self) -> list[int]:
        return list(self._partial)

    @property
    def tokens(self) -> np.ndarray:
        full = [t for b in self._blocks for t in b.tokens]
        return np.asarray(full + self._partial, dtype=np.int32)

    def __len__(self) -> int:
        return len(self._blocks) * self.block_size + len(self._partial)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"TokenBlockSequence(len={len(self)}, blocks={len(self._blocks)}, "
            f"partial={len(self._partial)}, block_size={self.block_size})"
        )


@dataclass(frozen=True)
class SaltedPrefix:
    """Optional per-model/per-lora salt prefix for cache identity separation.

    Two deployments serving different weights must never share block
    identities; mixing a model-unique value into the salt guarantees it.
    """

    model_id: str
    base_salt: int = DEFAULT_SALT

    @property
    def salt(self) -> int:
        return _hash_bytes(self.model_id.encode(), seed=self.base_salt) & 0xFFFF_FFFF_FFFF_FFFF
