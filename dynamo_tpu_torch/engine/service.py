"""Async engine service: the AsyncEngine facade over the synchronous core
(counterpart of ``dynamo_tpu/engine/service.py:JaxEngineService``).

One background loop owns the EngineCore (single writer): it drains the
intake queue, runs each engine step in a worker thread (so the event loop
keeps serving streams while the card computes), and fans step outputs out to
per-request asyncio queues. The step's kernels (a CUDA graph's replay on
the card) launch on the worker thread's current stream; the runner waits
for a step's tokens (an event after their copy to host) before handing
them back, and with ``EngineConfig.overlap`` the next step is already on
the stream by then. Committed pages are written through to the KV tiers
after each step's outputs are routed.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

logger = logging.getLogger(__name__)

_SENTINEL = object()


class TorchEngineService(AsyncEngine[Any, dict]):
    """Serves PreprocessedRequest (or its dict form) -> stream of EngineOutput dicts."""

    def __init__(self, core: EngineCore) -> None:
        self.core = core
        core.defer_offloads = True  # flushed after the step's outputs are routed (below)
        self._intake: asyncio.Queue = asyncio.Queue()
        self._streams: dict[int, asyncio.Queue] = {}
        self._loop_task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._closed = False
        self.aux: list = []  # companion tasks (metrics publisher, ...) closed with us

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "TorchEngineService":
        if self._closed:
            raise RuntimeError("engine service is closed")
        if self._loop_task is None:
            self._loop_task = asyncio.create_task(self._engine_loop(), name="torch-engine-loop")
        return self

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        for a in self.aux:
            await a.close()
        self.aux = []
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
        # Cancelling the loop task does not stop a core.step() already running
        # in the executor thread: abort_all takes the core's step_lock, so it
        # waits that step out before touching the state it mutates.
        await asyncio.get_running_loop().run_in_executor(None, self.core.abort_all)
        self._drain_intake_failed()
        if self._streams:
            self._notify_streams_failed()

    def _drain_intake_failed(self) -> None:
        """Fail requests queued but never admitted by the (now dead) loop."""
        while True:
            try:
                _req, _ctx, out_q = self._intake.get_nowait()
            except asyncio.QueueEmpty:
                break
            out_q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            out_q.put_nowait(_SENTINEL)

    # -- engine loop -------------------------------------------------------

    async def _engine_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            admitted = False
            while True:
                try:
                    request, context, out_q = self._intake.get_nowait()
                except asyncio.QueueEmpty:
                    break
                try:
                    seq = self.core.add_request(request, context)
                except Exception:
                    logger.exception("add_request failed; failing that request only")
                    out_q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
                    out_q.put_nowait(_SENTINEL)
                    admitted = True
                    continue
                self._streams[seq.seq_id] = out_q
                if seq.is_finished:  # rejected at intake
                    out_q.put_nowait(
                        EngineOutput(token_ids=[], finish_reason=seq.finish_reason, prompt_tokens=seq.num_prompt)
                    )
                    out_q.put_nowait(_SENTINEL)
                    del self._streams[seq.seq_id]
                admitted = True

            if not self.core.has_work:
                if not admitted:
                    self._wake.clear()
                    await self._wake.wait()
                continue

            try:
                outputs = await loop.run_in_executor(None, self.core.step)
            except Exception:
                logger.exception("engine step failed; failing all in-flight streams")
                self._notify_streams_failed()
                # Engine state may be inconsistent after a failed step: drop
                # all work, releasing every sequence's pages.
                self.core.abort_all()
                continue
            self._route(outputs)
            # Tier write-through after the outputs are routed, so token
            # delivery never waits on the page copies to the host.
            if self.core.pending_offloads:
                try:
                    await loop.run_in_executor(None, self.core.flush_offloads)
                except Exception:
                    logger.exception("tier offload flush failed (non-fatal)")

    def _notify_streams_failed(self) -> None:
        for q in self._streams.values():
            q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            q.put_nowait(_SENTINEL)
        self._streams.clear()

    def _route(self, outputs: list[tuple[Sequence, EngineOutput]]) -> None:
        for seq, out in outputs:
            q = self._streams.get(seq.seq_id)
            if q is None:
                continue
            q.put_nowait(out)
            if out.finish_reason is not None:
                q.put_nowait(_SENTINEL)
                del self._streams[seq.seq_id]

    # -- AsyncEngine -------------------------------------------------------

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        if isinstance(request, dict):
            request = PreprocessedRequest.from_dict(request)
        if self._closed:
            raise RuntimeError("engine service is closed")
        if request.annotations.get("embed"):
            raise NotImplementedError("embedding requests are not ported to dynamo_tpu_torch yet")
        await self.start()
        out_q: asyncio.Queue = asyncio.Queue()
        await self._intake.put((request, context, out_q))
        self._wake.set()
        if self._closed:
            # close() may have run between the check above and the put.
            out_q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            out_q.put_nowait(_SENTINEL)
        finished = False
        try:
            while True:
                item = await out_q.get()
                if item is _SENTINEL:
                    finished = True
                    return
                yield item.to_dict()
        finally:
            if not finished:
                # Consumer walked away: stop the sequence so it doesn't
                # decode to max_tokens.
                context.stop_generating()
                self._wake.set()

    def metrics(self) -> ForwardPassMetrics:
        return self.core.metrics()
