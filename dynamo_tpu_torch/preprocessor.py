"""Preprocessor stage: OpenAI request -> tokens (forward), deltas (backward).

A copy of ``dynamo_tpu/preprocessor.py`` for text requests: render the chat
template over the messages (chat) or take the raw prompt (completions),
tokenize, and extract sampling + stop conditions into a
``PreprocessedRequest``. ``jinja2`` is imported on the first chat request,
so completions need no template engine. Multimodal content and embedding
requests are not ported yet and are refused.
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, Operator
from dynamo_tpu_torch.tokenizer import BaseTokenizer

logger = logging.getLogger(__name__)

# Minimal fallback template (ChatML-ish) for models shipping none.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


class PromptFormatter:
    """Jinja chat-template renderer."""

    def __init__(self, template: str | None = None, *, bos_token: str = "", eos_token: str = "") -> None:
        import jinja2

        self._env = jinja2.Environment(keep_trailing_newline=True)  # noqa: S701 — prompts, not HTML
        self._template = self._env.from_string(template or DEFAULT_CHAT_TEMPLATE)
        self._bos = bos_token
        self._eos = eos_token

    def render(self, messages: list[dict[str, Any]], *, add_generation_prompt: bool = True, **extra: Any) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self._bos,
            eos_token=self._eos,
            **extra,
        )


def extract_sampling(body: dict[str, Any]) -> SamplingOptions:
    nvext = body.get("nvext") or {}
    temperature = body.get("temperature")
    # OpenAI logprobs: chat sends `logprobs: true` (+ `top_logprobs: N`);
    # completions sends `logprobs: N`. SamplingOptions encodes "enabled with
    # A alternatives" as A + 1 so 0 stays "off".
    raw_lp = body.get("logprobs")
    try:
        if raw_lp is True:
            n_alts = int(body.get("top_logprobs") or 0)
            lp = 1 + n_alts
        elif raw_lp is None or raw_lp is False or raw_lp == "":
            lp, n_alts = 0, 0
        else:
            n_alts = int(raw_lp)
            lp = 1 + n_alts
    except (TypeError, ValueError):
        raise ValueError(f"logprobs/top_logprobs must be integers, got {raw_lp!r}")
    if n_alts < 0 or n_alts > 20:  # OpenAI's top_logprobs range
        raise ValueError(f"logprobs/top_logprobs must be in [0, 20], got {n_alts}")
    return SamplingOptions(
        temperature=1.0 if temperature is None else float(temperature),
        top_k=int(nvext.get("top_k", body.get("top_k", 0)) or 0),
        top_p=float(body.get("top_p", 1.0) if body.get("top_p") is not None else 1.0),
        seed=body.get("seed"),
        frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
        presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
        logprobs=lp,
        json_mode=_json_mode_from(body.get("response_format")),
    )


def _json_mode_from(rf) -> bool:
    """Validate response_format (an unsupported type must not be ignored)."""
    if rf is None:
        return False
    if not isinstance(rf, dict) or "type" not in rf:
        raise ValueError(f"response_format must be an object with a 'type', got {rf!r}")
    kind = rf["type"]
    if kind == "json_object":
        return True
    if kind == "text":
        return False
    raise ValueError(f"unsupported response_format type {kind!r} (supported: text, json_object)")


def extract_stop(body: dict[str, Any], *, default_max_tokens: int) -> StopConditions:
    nvext = body.get("nvext") or {}
    stop = body.get("stop")
    if stop is None:
        stop_strings = []
    elif isinstance(stop, str):
        stop_strings = [stop]
    else:
        stop_strings = [s for s in stop if s]
    max_tokens = body.get("max_completion_tokens", body.get("max_tokens"))
    return StopConditions(
        max_tokens=int(max_tokens) if max_tokens is not None else default_max_tokens,
        stop_token_ids=list(nvext.get("stop_token_ids", body.get("stop_token_ids", []) or [])),
        stop_strings=stop_strings,
        ignore_eos=bool(nvext.get("ignore_eos", False)),
        min_tokens=int(nvext.get("min_tokens", 0) or 0),
    )


class OpenAIPreprocessor(Operator):
    """Operator: OpenAI chat/completions body (dict) -> PreprocessedRequest."""

    def __init__(
        self,
        downstream: AsyncEngine[Any, Any],
        tokenizer: BaseTokenizer,
        *,
        chat_template: str | None = None,
        default_max_tokens: int = 512,
        add_bos: bool = True,
    ) -> None:
        super().__init__(downstream)
        self.tokenizer = tokenizer
        self.chat_template = chat_template
        self._formatter: PromptFormatter | None = None
        self.default_max_tokens = default_max_tokens
        self.add_bos = add_bos

    @property
    def formatter(self) -> PromptFormatter:
        if self._formatter is None:
            self._formatter = PromptFormatter(self.chat_template)
        return self._formatter

    def preprocess(self, body: dict[str, Any]) -> PreprocessedRequest:
        if body.get("embed"):
            raise ValueError("embedding requests are not ported to dynamo_tpu_torch yet")
        token_ids: list[int] | None = None
        if "messages" in body:
            extra = {}
            if body.get("tools"):
                extra["tools"] = body["tools"]
            prompt = self.formatter.render(body["messages"], add_generation_prompt=True, **extra)
        else:
            raw = body.get("prompt", "")
            if isinstance(raw, str):
                prompt = raw
            elif isinstance(raw, list) and all(isinstance(t, int) for t in raw):
                # OpenAI allows pre-tokenized prompts (array of token ids).
                prompt, token_ids = None, list(raw)
            elif isinstance(raw, list) and len(raw) == 1 and isinstance(raw[0], str):
                prompt = raw[0]
            else:
                raise ValueError("unsupported 'prompt' type: expected string, token-id array, or single-element string array")
        if token_ids is None:
            token_ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        req = PreprocessedRequest(
            token_ids=token_ids,
            sampling=extract_sampling(body),
            stop=extract_stop(body, default_max_tokens=self.default_max_tokens),
            model=body.get("model"),
            request_id=body.get("request_id") or uuid.uuid4().hex,
            tenant_id=(body.get("tenant_id") or None),
            priority=int(body.get("priority") or 0),
        )
        annotations = body.get("nvext", {}).get("annotations") or []
        if "formatted_prompt" in annotations:
            req.annotations["formatted_prompt"] = prompt
        if "token_ids" in annotations:
            req.annotations["token_ids"] = list(token_ids)
        return req

    async def transform_request(self, request: Any, context: Context) -> dict:
        if not isinstance(request, dict):
            raise TypeError(f"preprocessor expects an OpenAI body dict, got {type(request)}")
        return self.preprocess(request).to_dict()

    def transform_stream(self, stream: AsyncIterator[Any], request: Any, context: Context) -> AsyncIterator[Any]:
        return stream
