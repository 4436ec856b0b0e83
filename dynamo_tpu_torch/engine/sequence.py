"""Per-request runtime state inside the engine.

A sequence tracks its tokens (prompt + generated), how many of them have KV
resident in the paged cache, its page list, and its hash-chained block
identities (for prefix-cache commit + KV events). Preemption resets the
cached count to zero while keeping tokens — recomputation then re-matches
whatever prefix survives in cache.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

from dynamo_tpu_torch.protocols.common import FinishReason, PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence


class SeqStatus(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclass
class Sequence:
    seq_id: int
    request: PreprocessedRequest
    context: Context
    block_seq: TokenBlockSequence  # hash-chained identity of self.tokens
    tokens: list[int] = field(default_factory=list)  # prompt + generated
    num_prompt: int = 0
    num_cached: int = 0  # tokens whose KV is in the paged cache
    num_cached_at_start: int = 0  # prefix-cache hits at admission (for usage stats)
    pages: list[int] = field(default_factory=list)
    committed_pages: int = 0  # pages already committed to the prefix cache
    # Forward chunks this (re)prefill has executed (chunked prefill
    # progress; reset on preemption along with num_cached).
    prefill_chunks: int = 0
    # Tier pages whose payload fetch is in flight (async onboarding): the
    # chunk scheduler skips the row until the session lands — num_cached
    # advances only then, exactly like an in-flight chunk. 0 once landed
    # (shortfall pages degrade to plain compute pages) or on preemption.
    onboard_pending: int = 0
    status: SeqStatus = SeqStatus.WAITING
    finish_reason: FinishReason | None = None
    # Image embeddings [total_image_tokens, D] substituted at placeholder
    # positions during prefill (multimodal; survives preemption/recompute).
    mm_embeds: "object | None" = None
    # Qwen2-VL M-RoPE: (pos3 i32[3, prompt_len], delta). Tokens past the
    # prompt (generated, incl. recompute) sit at index + delta on all axes.
    mrope: "tuple | None" = None
    # Constrained decoding state (response_format json_object); survives
    # preemption (the machine replays nothing — it tracks generated text).
    constraint: "object | None" = None
    arrival_time: float = field(default_factory=time.monotonic)
    first_token_time: float | None = None
    # SLO admission plane (dynamo_tpu/sched): when the scheduler admitted
    # this sequence into prefill (re-admission after preemption overwrites),
    # whether the admission wait has been reported downstream, and the
    # remaining TTFT the predictor estimated at the last EDF ordering (with
    # the timestamp of that estimate — the observation's time origin).
    admitted_time: float | None = None
    admission_reported: bool = False
    predicted_ttft_s: float | None = None
    predicted_at: float | None = None
    # True once the quota gate held this request back at any prepare():
    # its pre-admission wait is then charged to the "admission" loss cause
    # rather than plain "queue" (observability/attribution.py).
    quota_deferred: bool = False

    @classmethod
    def from_request(cls, seq_id: int, request: PreprocessedRequest, context: Context, *, page_size: int, salt: int) -> "Sequence":
        block_seq = TokenBlockSequence(request.token_ids, block_size=page_size, salt=salt)
        return cls(
            seq_id=seq_id,
            request=request,
            context=context,
            block_seq=block_seq,
            tokens=list(request.token_ids),
            num_prompt=len(request.token_ids),
        )

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.num_prompt

    @property
    def is_finished(self) -> bool:
        return self.status is SeqStatus.FINISHED

    @property
    def num_computed(self) -> int:
        """Tokens already through the forward pass. KV writes land in the
        same dispatch that computes a chunk, so this coincides with
        ``num_cached``; it exists as the scheduler-facing name — chunked
        prefill reasons about compute progress, the allocator about KV
        residency."""
        return self.num_cached

    @property
    def prompt_remaining(self) -> int:
        """Uncomputed tokens of the prompt (or, after preemption, of the
        prompt + generated recompute). 0 once fully prefilled; a mid-chunk
        sequence is not decodable until this reaches 0."""
        return max(0, len(self.tokens) - self.num_cached)

    def pages_needed(self, page_size: int, num_tokens_ahead: int = 1) -> int:
        """Extra pages needed to hold KV for the next ``num_tokens_ahead`` tokens."""
        target = self.num_cached + num_tokens_ahead
        need = -(-target // page_size)  # ceil
        return max(0, need - len(self.pages))

    def append_token(self, token: int) -> None:
        self.tokens.append(int(token))
        self.block_seq.append(int(token))

    def remaining_tokens(self, max_seq_len: int) -> int:
        """Tokens this sequence may still legitimately generate (the finish
        line check_stop enforces): bounded by max_tokens and the context
        window, never below 1 for a live sequence."""
        return max(
            1,
            min(
                self.request.stop.max_tokens - self.num_generated,
                max_seq_len - len(self.tokens),
            ),
        )

    def position_limit(self, max_seq_len: int) -> int:
        """First absolute position this sequence must never write KV at."""
        return min(self.num_prompt + self.request.stop.max_tokens, max_seq_len)

    def check_stop(self, eos_token_ids: set[int], max_seq_len: int) -> FinishReason | None:
        """Evaluate token-level stop conditions after a newly appended token."""
        stop = self.request.stop
        if self.context.is_stopped:
            return FinishReason.CANCELLED
        last = self.tokens[-1]
        if self.num_generated >= stop.min_tokens:
            if not stop.ignore_eos and last in eos_token_ids:
                return FinishReason.STOP
            if last in stop.stop_token_ids:
                return FinishReason.STOP
        if self.num_generated >= stop.max_tokens:
            return FinishReason.LENGTH
        if len(self.tokens) >= max_seq_len:
            return FinishReason.LENGTH  # context window reached
        return None
