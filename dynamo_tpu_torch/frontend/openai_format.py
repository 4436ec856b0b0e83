"""OpenAI response construction: SSE chunks + non-streaming aggregation (a copy
of ``dynamo_tpu/frontend/openai_format.py``).

Parity: reference `protocols/openai/chat_completions/delta.rs` (delta
generator) and `protocols/openai/*/aggregator.rs` (stream -> full response),
plus the SSE codec (`protocols/codec.rs`).
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.protocols.common import BackendOutput, FinishReason

_FINISH_MAP = {
    FinishReason.STOP: "stop",
    FinishReason.LENGTH: "length",
    FinishReason.CANCELLED: "stop",
    FinishReason.ERROR: "error",
}


def _finish_str(reason: FinishReason | None) -> str | None:
    return _FINISH_MAP.get(reason) if reason else None


def new_request_id(kind: str) -> str:
    return f"{kind}-{uuid.uuid4().hex}"


def _usage(prompt_tokens: int | None, completion_tokens: int, cached_tokens: int | None) -> dict[str, Any]:
    usage: dict[str, Any] = {
        "prompt_tokens": prompt_tokens or 0,
        "completion_tokens": completion_tokens,
        "total_tokens": (prompt_tokens or 0) + completion_tokens,
    }
    if cached_tokens:
        usage["prompt_tokens_details"] = {"cached_tokens": cached_tokens}
    return usage




def _legacy_top_logprobs(entries: list[dict]) -> list[dict[str, float]]:
    """BackendOutput.logprobs -> legacy completions ``top_logprobs``: one
    ``{token_text: logprob}`` dict per position. Distinct token ids can
    decode to the SAME text (partial-UTF-8 pieces all render as U+FFFD), and
    a plain dict comprehension silently drops all but one — keep the best
    logprob under the plain text and suffix the rest with their token id, so
    every one of the N requested alternatives survives."""
    out: list[dict[str, float]] = []
    for e in entries:
        d: dict[str, float] = {}
        for t in sorted(e.get("top", []), key=lambda t: t[1], reverse=True):
            key = t[2] if len(t) > 2 else str(t[0])
            while key in d:
                key = f"{key}#{t[0]}"
            d[key] = t[1]
        out.append(d)
    return out


def _chat_lp_content(entries: list[dict]) -> list[dict[str, Any]]:
    """BackendOutput.logprobs entries -> OpenAI chat `logprobs.content`."""
    out = []
    for e in entries:
        out.append({
            "token": e.get("token", ""),
            "logprob": e["logprob"],
            "bytes": e.get("bytes"),
            "top_logprobs": [
                {"token": t[2] if len(t) > 2 else "", "logprob": t[1],
                 "bytes": list(str(t[2]).encode()) if len(t) > 2 else None}
                for t in e.get("top", [])
            ],
        })
    return out


class ChatStream:
    """Builds chat.completion.chunk objects from BackendOutput deltas."""

    def __init__(self, model: str, *, request_id: str | None = None, send_usage: bool = False) -> None:
        self.id = request_id or new_request_id("chatcmpl")
        self.model = model
        self.created = int(time.time())
        self.send_usage = send_usage

    def _chunk(self, delta: dict[str, Any], finish: str | None = None, usage: dict | None = None) -> dict[str, Any]:
        out = {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
        }
        if usage is not None:
            out["usage"] = usage
        return out

    def first(self) -> dict[str, Any]:
        return self._chunk({"role": "assistant", "content": ""})

    def delta(self, out: BackendOutput) -> dict[str, Any]:
        usage = None
        if out.finish_reason is not None and self.send_usage:
            usage = _usage(out.prompt_tokens, out.cumulative_tokens, out.cached_tokens)
        chunk = self._chunk(
            {"content": out.text} if out.text else {},
            finish=_finish_str(out.finish_reason),
            usage=usage,
        )
        if out.logprobs:
            chunk["choices"][0]["logprobs"] = {"content": _chat_lp_content(out.logprobs)}
        return chunk

    def text_chunk(self, text: str) -> dict[str, Any]:
        return self._chunk({"content": text})

    def tool_calls_final(self, calls: list[dict[str, Any]], out: BackendOutput) -> dict[str, Any]:
        """Terminal chunk carrying the parsed tool calls (streaming shape:
        each call gets a list index) with finish_reason "tool_calls"."""
        usage = None
        if self.send_usage:
            usage = _usage(out.prompt_tokens, out.cumulative_tokens, out.cached_tokens)
        deltas = [
            {"index": i, "id": c["id"], "type": c["type"], "function": c["function"]}
            for i, c in enumerate(calls)
        ]
        return self._chunk({"tool_calls": deltas}, finish="tool_calls", usage=usage)


class CompletionStream:
    """Builds text_completion chunks from BackendOutput deltas."""

    def __init__(self, model: str, *, request_id: str | None = None, send_usage: bool = False) -> None:
        self.id = request_id or new_request_id("cmpl")
        self.model = model
        self.created = int(time.time())
        self.send_usage = send_usage

    def delta(self, out: BackendOutput) -> dict[str, Any]:
        chunk: dict[str, Any] = {
            "id": self.id,
            "object": "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": [
                {"index": 0, "text": out.text, "finish_reason": _finish_str(out.finish_reason),
                 "logprobs": None if not out.logprobs else {
                     "tokens": [e.get("token", "") for e in out.logprobs],
                     "token_logprobs": [e["logprob"] for e in out.logprobs],
                     "top_logprobs": _legacy_top_logprobs(out.logprobs),
                 }}
            ],
        }
        if out.finish_reason is not None and self.send_usage:
            chunk["usage"] = _usage(out.prompt_tokens, out.cumulative_tokens, out.cached_tokens)
        return chunk


async def aggregate_chat(
    model: str, stream: AsyncIterator[BackendOutput], *, parse_tools: bool = False
) -> dict[str, Any]:
    """Drain a backend stream into a full chat.completion response.

    ``parse_tools`` (set when the request declared ``tools``) lifts emitted
    tool-call blocks into ``message.tool_calls`` / ``finish_reason:
    "tool_calls"`` (see `frontend/tool_calls.py`)."""
    text_parts: list[str] = []
    finish: FinishReason | None = None
    prompt_tokens = cached = None
    completion_tokens = 0
    lp_entries: list[dict] = []
    async for out in stream:
        text_parts.append(out.text)
        completion_tokens = max(completion_tokens, out.cumulative_tokens)
        if out.logprobs:
            lp_entries.extend(out.logprobs)
        if out.finish_reason is not None:
            finish = out.finish_reason
            prompt_tokens, cached = out.prompt_tokens, out.cached_tokens
    text = "".join(text_parts)
    message: dict[str, Any] = {"role": "assistant", "content": text}
    finish_str = _finish_str(finish) or "stop"
    if parse_tools:
        from dynamo_tpu_torch.frontend.tool_calls import parse_tool_calls

        content, calls = parse_tool_calls(text)
        if calls:
            message = {"role": "assistant", "content": content or None, "tool_calls": calls}
            finish_str = "tool_calls"
    return {
        "id": new_request_id("chatcmpl"),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": message,
                "finish_reason": finish_str,
                **({"logprobs": {"content": _chat_lp_content(lp_entries)}} if lp_entries else {}),
            }
        ],
        "usage": _usage(prompt_tokens, completion_tokens, cached),
    }


async def aggregate_completion(model: str, stream: AsyncIterator[BackendOutput]) -> dict[str, Any]:
    text_parts: list[str] = []
    finish: FinishReason | None = None
    prompt_tokens = cached = None
    completion_tokens = 0
    lp_entries: list[dict] = []
    async for out in stream:
        text_parts.append(out.text)
        completion_tokens = max(completion_tokens, out.cumulative_tokens)
        if out.logprobs:
            lp_entries.extend(out.logprobs)
        if out.finish_reason is not None:
            finish = out.finish_reason
            prompt_tokens, cached = out.prompt_tokens, out.cached_tokens
    return {
        "id": new_request_id("cmpl"),
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": 0, "text": "".join(text_parts), "finish_reason": _finish_str(finish) or "stop",
             "logprobs": None if not lp_entries else {
                 "tokens": [e.get("token", "") for e in lp_entries],
                 "token_logprobs": [e["logprob"] for e in lp_entries],
                 "top_logprobs": _legacy_top_logprobs(lp_entries),
             }}
        ],
        "usage": _usage(prompt_tokens, completion_tokens, cached),
    }


def sse_encode(obj: dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
