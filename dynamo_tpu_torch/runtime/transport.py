"""Request/response data plane and its in-memory implementation (a copy of
``dynamo_tpu/runtime/transport.py`` without the duplex stream).

A ``Transport`` carries one operation: open a response stream on a remote
engine registered under a *subject* (the flattened endpoint address of one
instance). Workers bind subjects to engines; callers call ``generate``.

The in-memory transport fakes the network contract in-process: every
request and response is round-tripped through msgpack, so anything that
would not cross the wire fails here too (requests cross as ``to_dict``
dicts), and cancellation crosses through the context chain as STOP/KILL
frames would. The TCP transport and its codec, and the duplex stream the
disaggregated KV path uses, are not ported yet.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator

import msgpack

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, EngineError


class NoSuchSubjectError(KeyError):
    """The target instance does not serve this subject (stale discovery, dead worker)."""


class Transport(abc.ABC):
    """Binds engines to subjects (worker side) and opens streams (caller side)."""

    @abc.abstractmethod
    async def register_engine(self, subject: str, engine: AsyncEngine[Any, Any]) -> None: ...

    @abc.abstractmethod
    async def unregister_engine(self, subject: str) -> None: ...

    @abc.abstractmethod
    def generate(self, address: str, request: Any, context: Context) -> AsyncIterator[Any]:
        """Open a response stream on the engine at ``address`` (subject or URL)."""
        ...

    @abc.abstractmethod
    def address_of(self, subject: str) -> str:
        """The externally-dialable address for a locally-registered subject."""
        ...

    async def close(self) -> None:  # pragma: no cover - default no-op
        pass


class InMemoryTransport(Transport):
    """In-process transport with network-faithful semantics.

    Payloads are round-tripped through msgpack so anything non-serializable
    fails here exactly as it would on the wire; cancellation crosses the
    "network" via the context chain exactly as STOP/KILL frames would.
    """

    def __init__(self) -> None:
        self._engines: dict[str, AsyncEngine[Any, Any]] = {}

    async def register_engine(self, subject: str, engine: AsyncEngine[Any, Any]) -> None:
        if subject in self._engines:
            raise ValueError(f"subject already registered: {subject}")
        self._engines[subject] = engine

    async def unregister_engine(self, subject: str) -> None:
        self._engines.pop(subject, None)

    def address_of(self, subject: str) -> str:
        return f"mem://{subject}"

    def _roundtrip(self, obj: Any) -> Any:
        return msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False)

    async def generate(self, address: str, request: Any, context: Context) -> AsyncIterator[Any]:
        subject = address.removeprefix("mem://")
        engine = self._engines.get(subject)
        if engine is None:
            raise NoSuchSubjectError(subject)
        remote_ctx = context.child()
        stream = engine.generate(self._roundtrip(request), remote_ctx)
        try:
            while True:
                try:
                    item = await anext(stream)
                except StopAsyncIteration:
                    break
                except Exception as exc:
                    # On the wire an engine failure arrives as an ERROR frame;
                    # keep the in-process contract identical.
                    raise EngineError(f"{type(exc).__name__}: {exc}") from exc
                if context.is_killed:
                    break
                yield self._roundtrip(item)
        finally:
            remote_ctx.kill()
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()


__all__ = [
    "Transport",
    "InMemoryTransport",
    "NoSuchSubjectError",
    "EngineError",
]
