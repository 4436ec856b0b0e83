"""Tool-call extraction from generated text (a copy of
``dynamo_tpu/frontend/tool_calls.py``).

OpenAI tool calling: the model emits a structured function invocation inside
its text; the frontend lifts it into ``message.tool_calls`` with
``finish_reason: "tool_calls"``. Two wire formats cover the shipped model
families:

- Hermes/Qwen style: ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>``
  (possibly several blocks).
- Llama-3 JSON style: the entire message is one JSON object
  ``{"name": ..., "parameters": {...}}``.

Parity: reference `lib/llm/src/preprocessor/tools/*` (request-side tool
schema injection) and its response parsers; parsing is frontend-side here
because the backend stage is detokenize-only by design.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any

_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)


def _mk_call(name: str, arguments: Any) -> dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def parse_tool_calls(text: str) -> tuple[str, list[dict[str, Any]]]:
    """Split generated text into (content, tool_calls).

    Returns the text with tool-call blocks removed and the parsed calls in
    OpenAI response shape. Unparseable blocks stay in the content untouched
    (the caller falls back to a plain text message).
    """
    calls: list[dict[str, Any]] = []

    def lift(m: re.Match) -> str:
        try:
            obj = json.loads(m.group(1))
            name = obj["name"]
        except Exception:
            return m.group(0)  # malformed: leave in content
        calls.append(_mk_call(name, obj.get("arguments", obj.get("parameters", {}))))
        return ""

    content = _TOOL_CALL_RE.sub(lift, text)
    if not calls:
        # Llama-3 style: the whole message is one JSON function call.
        stripped = text.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            try:
                obj = json.loads(stripped)
                if isinstance(obj, dict) and "name" in obj and ("parameters" in obj or "arguments" in obj):
                    calls.append(_mk_call(obj["name"], obj.get("arguments", obj.get("parameters", {}))))
                    content = ""
            except Exception:
                pass
    return content.strip() if calls else text, calls


class ToolCallStreamJail:
    """Streaming guard: holds back text that may be tool-call markup.

    ``push(delta_text)`` returns the prefix that is provably plain content;
    anything that could open a ``<tool_call>`` block — or a message whose
    first character is ``{`` (the bare-JSON call style) — is buffered.
    ``finish()`` parses the held text and returns ``(trailing_text, calls)``.

    Mirrors the backend's StopStringJail pattern so streaming clients with
    ``tools`` declared receive ``tool_calls`` deltas instead of raw markup.
    """

    MARKER = "<tool_call>"

    def __init__(self) -> None:
        self._buf = ""
        self._holding_all = False  # saw a call opener: buffer to end of stream
        self._seen_content = False

    def push(self, text: str) -> str:
        self._buf += text
        if self._holding_all:
            return ""
        s = self._buf
        if not self._seen_content:
            stripped = s.lstrip()
            if not stripped:
                return ""
            self._seen_content = True
            if stripped.startswith("{"):
                self._holding_all = True  # possible bare-JSON call
                return ""
        i = s.find(self.MARKER)
        if i != -1:
            self._holding_all = True
            out, self._buf = s[:i], s[i:]
            return out
        # Release all but a tail that is a proper prefix of the marker.
        keep = 0
        for n in range(min(len(self.MARKER) - 1, len(s)), 0, -1):
            if self.MARKER.startswith(s[-n:]):
                keep = n
                break
        out, self._buf = s[: len(s) - keep], s[len(s) - keep :]
        return out

    def finish(self) -> tuple[str, list[dict[str, Any]]]:
        content, calls = parse_tool_calls(self._buf)
        self._buf = ""
        return content, calls
