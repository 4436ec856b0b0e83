"""Backend (postprocessor) stage: tokens -> text, stop-string detection.

Sits on the response path between the engine and the preprocessor. For each
request it keeps an incremental detokenizer and a stop-string *jail*: text
that could still turn out to be the prefix of a stop string is held back and
only released once disambiguated — so clients never see a partial stop
sequence flash by, and never miss text when no stop fires.

On a stop-string hit the stream ends with ``FinishReason.STOP``, output
truncated at the match start (hidden stop, OpenAI semantics), and the
downstream engine stream is closed, which propagates cancellation to the
scheduler (transport teardown == kill).

Parity: reference `lib/llm/src/backend.rs:63-433` (Decoder/DecodeStream, stop
triggers, jail/unjail).
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.protocols.common import BackendOutput, EngineOutput, FinishReason, PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, Operator
from dynamo_tpu_torch.tokenizer import BaseTokenizer, IncrementalDetokenizer


class StopStringJail:
    """Streams text while withholding any suffix that may begin a stop string."""

    def __init__(self, stop_strings: list[str]) -> None:
        self._stops = [s for s in stop_strings if s]
        self._max_hold = max((len(s) - 1 for s in self._stops), default=0)
        self._pending = ""
        self.triggered: str | None = None

    def push(self, text: str) -> str:
        """Feed new text; return releasable text. Sets ``triggered`` on a hit."""
        if not self._stops:
            return text
        if self.triggered is not None:
            return ""
        self._pending += text
        # Full match anywhere in pending?
        earliest = -1
        for s in self._stops:
            idx = self._pending.find(s)
            if idx != -1 and (earliest == -1 or idx < earliest):
                earliest = idx
                self.triggered = s
        if self.triggered is not None:
            out = self._pending[:earliest]
            self._pending = ""
            return out
        # Hold back the longest tail that is a prefix of some stop string.
        hold = 0
        for k in range(min(self._max_hold, len(self._pending)), 0, -1):
            tail = self._pending[-k:]
            if any(s.startswith(tail) for s in self._stops):
                hold = k
                break
        out = self._pending[: len(self._pending) - hold]
        self._pending = self._pending[len(self._pending) - hold :]
        return out

    def flush(self) -> str:
        """Release anything still jailed (stream ended without a stop hit)."""
        out, self._pending = self._pending, ""
        return out


class Backend(Operator):
    """Operator: forwards PreprocessedRequest unchanged; detokenizes the
    response stream and enforces stop strings."""

    def __init__(self, downstream: AsyncEngine[Any, Any], tokenizer: BaseTokenizer) -> None:
        super().__init__(downstream)
        self.tokenizer = tokenizer

    async def transform_request(self, request: Any, context: Context) -> Any:
        return request

    def transform_stream(
        self, stream: AsyncIterator[Any], request: Any, context: Context
    ) -> AsyncIterator[BackendOutput]:
        if isinstance(request, dict):
            request = PreprocessedRequest.from_dict(request)
        return self._decode_stream(stream, request, context)

    async def _decode_stream(
        self, stream: AsyncIterator[Any], request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[BackendOutput]:
        detok = IncrementalDetokenizer(self.tokenizer)
        jail = StopStringJail(request.stop.stop_strings)
        async for item in stream:
            out = EngineOutput.from_dict(item) if isinstance(item, dict) else item
            if out.embedding is not None:  # embeddings: nothing to detokenize
                yield BackendOutput(
                    finish_reason=out.finish_reason,
                    prompt_tokens=out.prompt_tokens,
                    cached_tokens=out.cached_tokens,
                    embedding=out.embedding,
                )
                if out.finish_reason is not None:  # one output per batch input
                    return
                continue
            lp = None
            if out.logprobs:
                # Per-token text for the OpenAI logprobs schema. A lone token
                # may be a partial UTF-8 piece; "bytes" carries the exact
                # bytes (the schema's escape hatch for that).
                lp = []
                for e in out.logprobs:
                    piece = self.tokenizer.decode([e["id"]], skip_special_tokens=False)
                    lp.append({
                        **e, "token": piece, "bytes": list(piece.encode()),
                        "top": [
                            [tid, tlp, self.tokenizer.decode([tid], skip_special_tokens=False)]
                            for tid, tlp in e.get("top", [])
                        ],
                    })
            text = detok.push(out.token_ids) if out.token_ids else ""
            released = jail.push(text)
            if jail.triggered is not None:
                # Hidden stop: truncate, finish, and cancel the engine stream.
                yield BackendOutput(
                    text=released,
                    token_ids=out.token_ids,
                    finish_reason=FinishReason.STOP,
                    cumulative_tokens=out.cumulative_tokens,
                    prompt_tokens=out.prompt_tokens,
                    cached_tokens=out.cached_tokens,
                    logprobs=lp,
                    admission_wait_ms=out.admission_wait_ms,
                )
                return  # Operator.generate closes the stream -> engine cancels
            final = out.finish_reason is not None
            if final:
                released += jail.flush()
            if released or out.token_ids or final:
                yield BackendOutput(
                    text=released,
                    token_ids=out.token_ids,
                    finish_reason=out.finish_reason,
                    cumulative_tokens=out.cumulative_tokens,
                    prompt_tokens=out.prompt_tokens,
                    cached_tokens=out.cached_tokens,
                    logprobs=lp,
                    admission_wait_ms=out.admission_wait_ms,
                )
            if final:
                return
