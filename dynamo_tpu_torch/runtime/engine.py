"""The core streaming-engine abstraction and request lifecycle.

Every stage in a serving pipeline — preprocessor, router, backend, the JAX
engine itself — implements the same shape: ``generate(request, context) ->
async stream of responses``. Composition of stages is then uniform, and a
pipeline can be split across processes at any stage boundary by inserting the
network transport (which itself implements the same shape).

Capability parity: reference `lib/runtime/src/engine.rs:124-212` (AsyncEngine
trait + AsyncEngineContext stop/kill lifecycle) and
`lib/runtime/src/pipeline.rs` operator edges.
"""

from __future__ import annotations

import abc
import asyncio
import uuid
from typing import Any, AsyncIterator, Generic, TypeVar

Req = TypeVar("Req")
Resp = TypeVar("Resp")


class EngineError(RuntimeError):
    """Raised inside a response stream when the producing engine fails."""


class Context:
    """Per-request lifecycle handle flowing through every pipeline stage.

    Two levels of cancellation, matching the reference semantics:

    - ``stop_generating()`` — graceful: the engine should finish the current
      step, emit any final usage/stop metadata, and end the stream.
    - ``kill()`` — hard: tear the stream down immediately (implies stop).

    Contexts form a chain: child contexts (created when a stage issues its own
    downstream request) propagate cancellation downward.

    ``trace`` carries the distributed trace identity (a plain
    ``{"trace_id", "span_id"}`` dict — serializable form of
    :class:`dynamo_tpu.tracing.TraceContext`) through every stage: the
    frontend mints it, operators pass the context (or a child) downstream,
    and the network transport forwards it on the wire so spans on remote
    workers link back to the same trace.
    """

    def __init__(self, request_id: str | None = None, *, trace: dict | None = None) -> None:
        self.id: str = request_id or uuid.uuid4().hex
        self.trace: dict | None = trace
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()
        self._children: list[Context] = []

    # -- cancellation ------------------------------------------------------

    def stop_generating(self) -> None:
        self._stop.set()
        for c in self._children:
            c.stop_generating()

    def kill(self) -> None:
        self._kill.set()
        self._stop.set()
        for c in self._children:
            c.kill()

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def is_killed(self) -> bool:
        return self._kill.is_set()

    async def wait_stopped(self) -> None:
        await self._stop.wait()

    async def wait_killed(self) -> None:
        await self._kill.wait()

    # -- chaining ----------------------------------------------------------

    def child(self) -> "Context":
        c = Context(request_id=self.id, trace=self.trace)
        if self.is_stopped:
            c.stop_generating()
        if self.is_killed:
            c.kill()
        self._children.append(c)
        return c


class AsyncEngine(abc.ABC, Generic[Req, Resp]):
    """A stage that turns one request into an async stream of responses."""

    @abc.abstractmethod
    def generate(self, request: Req, context: Context) -> AsyncIterator[Resp]:
        """Produce the response stream for ``request``.

        Implementations must observe ``context``: exit promptly after
        ``stop_generating()`` and immediately after ``kill()``.
        """
        raise NotImplementedError


class Operator(AsyncEngine[Req, Resp]):
    """A pipeline stage wrapping a downstream engine.

    Subclasses override :meth:`transform_request` (forward edge) and/or
    :meth:`transform_stream` (backward edge). Mirrors the reference's
    forward/backward Operator nodes (`lib/runtime/src/pipeline/nodes.rs`).
    """

    def __init__(self, downstream: AsyncEngine[Any, Any]) -> None:
        self.downstream = downstream

    async def transform_request(self, request: Req, context: Context) -> Any:
        return request

    def transform_stream(self, stream: AsyncIterator[Any], request: Req, context: Context) -> AsyncIterator[Resp]:
        return stream  # type: ignore[return-value]

    async def generate(self, request: Req, context: Context) -> AsyncIterator[Resp]:
        downstream_req = await self.transform_request(request, context)
        stream = self.downstream.generate(downstream_req, context)
        transformed = self.transform_stream(stream, request, context)
        try:
            async for item in transformed:
                yield item
        finally:
            for s in (transformed, stream):
                aclose = getattr(s, "aclose", None)
                if aclose is not None:
                    await aclose()


async def collect(stream: AsyncIterator[Resp]) -> list[Resp]:
    """Drain a response stream into a list (test/utility helper)."""
    return [item async for item in stream]
