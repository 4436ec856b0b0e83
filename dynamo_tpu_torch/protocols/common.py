"""Internal inter-stage protocol: preprocessed requests and engine outputs.

Parity: reference `lib/llm/src/protocols/common/*` — `PreprocessedRequest`
(token_ids + sampling + stop conditions, produced by the preprocessor and
consumed by router/engine) and `BackendOutput`/`LLMEngineOutput` (token deltas
flowing back). Everything is a plain dataclass serializable to/from dicts so
it crosses the stream transport as msgpack/JSON without bespoke codecs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class FinishReason(str, Enum):
    STOP = "stop"  # stop condition (eos / stop token / stop string)
    LENGTH = "length"  # max_tokens or context window reached
    CANCELLED = "cancelled"  # client stopped/killed the request
    ERROR = "error"


@dataclass
class SamplingOptions:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # <=0 => disabled
    top_p: float = 1.0  # >=1 => disabled
    seed: int | None = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # OpenAI logprobs: 0 = off; N > 0 = enabled with N-1 top alternatives
    # per generated token (the +1 encoding lets "chosen token only, zero
    # alternatives" — chat top_logprobs: 0 / completions logprobs: 0 —
    # stay distinct from off). The reference leaves this a TODO
    # (`completions.rs:262`); first-party here.
    logprobs: int = 0
    # OpenAI response_format {"type": "json_object"}: constrain sampling so
    # the output is always a valid JSON prefix and force-close before the
    # token budget runs out (dynamo_tpu/constrained.py).
    json_mode: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SamplingOptions":
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class StopConditions:
    max_tokens: int = 512
    stop_token_ids: list[int] = field(default_factory=list)
    stop_strings: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StopConditions":
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class PreprocessedRequest:
    """Tokenized request: what the router schedules and the engine executes."""

    token_ids: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    model: str | None = None
    request_id: str | None = None
    annotations: dict[str, Any] = field(default_factory=dict)
    # Multimodal embeddings handle (filled by encode workers; see models/vision).
    mm_inputs: dict[str, Any] | None = None
    # Multi-tenant admission control (dynamo_tpu/sched): tenant identity from
    # the frontend's x-dynamo-tenant header (None = the shared default
    # tenant) and priority tier (0 = most latency-sensitive; each higher tier
    # stretches the EDF deadline budget — relaxed, never starved).
    tenant_id: str | None = None
    priority: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "token_ids": list(self.token_ids),
            "sampling": self.sampling.to_dict(),
            "stop": self.stop.to_dict(),
            "model": self.model,
            "request_id": self.request_id,
            "annotations": self.annotations,
            "mm_inputs": self.mm_inputs,
            "tenant_id": self.tenant_id,
            "priority": self.priority,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions.from_dict(d.get("sampling", {})),
            stop=StopConditions.from_dict(d.get("stop", {})),
            model=d.get("model"),
            request_id=d.get("request_id"),
            annotations=d.get("annotations", {}) or {},
            mm_inputs=d.get("mm_inputs"),
            tenant_id=d.get("tenant_id"),
            priority=int(d.get("priority") or 0),
        )


@dataclass
class BackendOutput:
    """Detokenized delta leaving the backend (postprocessor) stage."""

    text: str = ""
    token_ids: list[int] = field(default_factory=list)
    finish_reason: FinishReason | None = None
    cumulative_tokens: int = 0
    prompt_tokens: int | None = None
    cached_tokens: int | None = None
    embedding: list[float] | None = None  # /v1/embeddings result (no tokens stream)
    # Per generated token: {"id", "token", "bytes", "logprob",
    # "top": [[id, lp, token], ...]} (wire order: id, logprob, token).
    logprobs: list[dict] | None = None
    # Engine admission wait (add_request -> first scheduling), reported once
    # on the request's first delta; None on later deltas.
    admission_wait_ms: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "text": self.text,
            "token_ids": list(self.token_ids),
            "finish_reason": self.finish_reason.value if self.finish_reason else None,
            "cumulative_tokens": self.cumulative_tokens,
            "prompt_tokens": self.prompt_tokens,
            "cached_tokens": self.cached_tokens,
            "embedding": self.embedding,
            "logprobs": self.logprobs,
            "admission_wait_ms": self.admission_wait_ms,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BackendOutput":
        fr = d.get("finish_reason")
        return cls(
            text=d.get("text", ""),
            token_ids=list(d.get("token_ids", [])),
            finish_reason=FinishReason(fr) if fr else None,
            cumulative_tokens=d.get("cumulative_tokens", 0),
            prompt_tokens=d.get("prompt_tokens"),
            cached_tokens=d.get("cached_tokens"),
            embedding=d.get("embedding"),
            logprobs=d.get("logprobs"),
            admission_wait_ms=d.get("admission_wait_ms"),
        )


@dataclass
class EngineOutput:
    """One streamed delta from the engine: newly generated token ids."""

    token_ids: list[int]
    finish_reason: FinishReason | None = None
    cumulative_tokens: int = 0
    # Usage metadata on the final delta.
    prompt_tokens: int | None = None
    cached_tokens: int | None = None
    embedding: list[float] | None = None  # /v1/embeddings result (no tokens stream)
    # Per token in token_ids: {"id", "logprob", "top": [[id, lp], ...]};
    # None when the request didn't ask (SamplingOptions.logprobs == 0).
    logprobs: list[dict] | None = None
    # Engine admission wait (add_request -> first scheduling), attached to
    # the sequence's first delta only (frontend RequestTracker observes it).
    admission_wait_ms: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "token_ids": list(self.token_ids),
            "finish_reason": self.finish_reason.value if self.finish_reason else None,
            "cumulative_tokens": self.cumulative_tokens,
            "prompt_tokens": self.prompt_tokens,
            "cached_tokens": self.cached_tokens,
            "embedding": self.embedding,
            "logprobs": self.logprobs,
            "admission_wait_ms": self.admission_wait_ms,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EngineOutput":
        fr = d.get("finish_reason")
        return cls(
            token_ids=list(d.get("token_ids", [])),
            finish_reason=FinishReason(fr) if fr else None,
            cumulative_tokens=d.get("cumulative_tokens", 0),
            prompt_tokens=d.get("prompt_tokens"),
            cached_tokens=d.get("cached_tokens"),
            embedding=d.get("embedding"),
            logprobs=d.get("logprobs"),
            admission_wait_ms=d.get("admission_wait_ms"),
        )
