"""Request-level tracing spans (a copy of the span half of
``dynamo_tpu/tracing.py``).

- **Request spans**: :class:`Span` measures one phase of one request and
  logs it as a structured record, giving grep-able per-request latency
  breakdowns without a collector service. Every finished span also lands in
  the per-process :class:`SpanBuffer` ring (:data:`SPANS`), queryable by
  request or trace id — the storage behind ``GET /debug/traces/{request_id}``.
- **Distributed trace identity**: :class:`TraceContext` carries a W3C
  ``traceparent``-compatible (trace_id, span_id) pair across hops. The
  frontend mints (or ingests) it and it rides the per-request ``Context``
  through the router and the client, so their spans share one ``trace_id``
  and parent/child links.

The device-trace half (XPlane captures and ``POST /engine/profile``) is not
ported yet.
"""

from __future__ import annotations

import logging
import os
import re
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

logger = logging.getLogger("dynamo.trace")

_TRACEPARENT_RE = re.compile(r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass(frozen=True)
class TraceContext:
    """A W3C-trace-context-compatible (trace_id, span_id) pair.

    ``trace_id`` names the whole distributed request; ``span_id`` names the
    *current* span — a child span created under this context records it as
    ``parent_id``. The dict form (plain strings) is what rides msgpack/JSON
    hops: the runtime ``Context.trace`` field, through the transport.
    """

    trace_id: str
    span_id: str

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(trace_id=_new_trace_id(), span_id=_new_span_id())

    @classmethod
    def from_traceparent(cls, header: str | None) -> "TraceContext | None":
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m is None:
            return None
        return cls(trace_id=m.group(1), span_id=m.group(2))

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, obj: Any) -> "TraceContext | None":
        if not isinstance(obj, dict) or "trace_id" not in obj:
            return None
        return cls(trace_id=str(obj["trace_id"]), span_id=str(obj.get("span_id", "")))


# -- span collection ----------------------------------------------------------


class SpanBuffer:
    """Bounded per-process ring of finished spans (thread-safe).

    Spans are plain dicts (see :meth:`Span._record`): name, trace/span/parent
    ids, request_id, wall + monotonic start, duration, status ok|error and
    the exception type on failure. ``GET /debug/traces/{request_id}`` fans
    out to every worker's buffer and assembles one timeline from the union.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self._spans: deque[dict] = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def record(self, span: dict) -> None:
        with self._lock:
            self._spans.append(span)

    def query(self, *, request_id: str | None = None, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        if request_id is not None:
            spans = [s for s in spans if s.get("request_id") == request_id]
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def _buffer_capacity() -> int:
    try:
        return int(os.environ.get("DYN_SPAN_BUFFER", "4096"))
    except ValueError:
        return 4096


#: The per-process span ring every finished Span records into.
SPANS = SpanBuffer(_buffer_capacity())

class Span:
    """One timed phase of one request, logged as structured JSONL.

    >>> with Span("prefill", trace=ctx, request_id=rid, tokens=len(ids)):
    ...     ...

    Logs ``{"span": "prefill", "duration_ms": 12.3, "trace_id": ...,
    "span_id": ..., "parent_id": ..., "status": "ok", ...}`` at DEBUG (set
    the ``dynamo.trace`` logger to DEBUG to collect). A raise
    inside the block still records the span — ``status="error"`` with the
    exception type under ``error`` — and propagates. Every exit also lands
    the span in :data:`SPANS`.

    ``trace`` threads the distributed identity: the span's ``parent_id`` is
    the incoming context's span_id, and :attr:`context` is what downstream
    hops should receive (same trace_id, this span as parent).
    """

    __slots__ = (
        "name", "fields", "t0", "t_wall",
        "trace_id", "span_id", "parent_id", "status", "error_type",
    )

    def __init__(self, name: str, *, trace: TraceContext | None = None, **fields: Any) -> None:
        self.name = name
        self.fields = fields
        if trace is not None:
            self.trace_id = trace.trace_id
            self.parent_id = trace.span_id or None
        else:
            self.trace_id = _new_trace_id()  # root of a fresh trace
            self.parent_id = None
        self.span_id = _new_span_id()
        self.status = "ok"
        self.error_type: str | None = None
        self.t0 = 0.0
        self.t_wall = 0.0

    @property
    def context(self) -> TraceContext:
        """The context downstream hops should inherit (this span as parent)."""
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        self.t_wall = time.time()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        ms = (time.perf_counter() - self.t0) * 1e3
        if exc_type is not None:
            self.status = "error"
            self.error_type = exc_type.__name__
        extra = {
            "span": self.name, "duration_ms": round(ms, 3),
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "status": self.status,
            **self.fields,
        }
        if self.error_type is not None:
            extra["error"] = self.error_type
            logger.warning("span %s failed after %.1fms", self.name, ms, extra=extra)
        else:
            logger.debug("span %s %.1fms", self.name, ms, extra=extra)
        self._record(ms)

    def _record(self, duration_ms: float) -> None:
        doc: dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.t_wall,
            "start_mono": self.t0,
            "duration_ms": round(duration_ms, 3),
            "status": self.status,
        }
        if self.error_type is not None:
            doc["error"] = self.error_type
        for k, v in self.fields.items():
            doc.setdefault(k, v)
        SPANS.record(doc)


def record_span(
    name: str,
    duration_ms: float,
    *,
    trace: TraceContext | None = None,
    start_ts: float | None = None,
    status: str = "ok",
    **fields: Any,
) -> dict:
    """Record an already-measured phase as a finished span.

    For durations captured by existing instrumentation (the KV-wire
    gather/pack/wire phase clocks, queue-wait gaps computed from enqueue
    stamps) where wrapping the work in a ``with Span(...)`` block is not
    possible after the fact. Returns the recorded span dict.
    """
    span = Span(name, trace=trace, **fields)
    span.t_wall = start_ts if start_ts is not None else time.time() - duration_ms / 1e3
    span.t0 = time.perf_counter() - duration_ms / 1e3
    span.status = status
    logger.debug(
        "span %s %.1fms", name, duration_ms,
        extra={
            "span": name, "duration_ms": round(duration_ms, 3),
            "trace_id": span.trace_id, "span_id": span.span_id,
            "parent_id": span.parent_id, "status": status, **fields,
        },
    )
    span._record(duration_ms)
    return {
        "name": name, "trace_id": span.trace_id, "span_id": span.span_id,
        "parent_id": span.parent_id, "duration_ms": round(duration_ms, 3),
        "status": status, **fields,
    }


def trace_of(context: Any) -> TraceContext | None:
    """The TraceContext riding a runtime ``Context`` (or None)."""
    return TraceContext.from_dict(getattr(context, "trace", None))
