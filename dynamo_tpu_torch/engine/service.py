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

Each request leaves the JAX service's spans in the span ring
(``tracing.SPANS``, under the request's trace): ``engine_queue_wait``
(intake to the engine loop), ``engine_admission_wait`` (arrival to
admission, as the core measured it), ``engine_first_token`` and
``engine_request`` (the whole stream). A failed step (the ``engine.step``
fault point fires before each one) records a CRASH flight record, dumps the
core's flight ring to JSONL (``DYN_FLIGHT_DUMP_DIR``), fails every
in-flight stream with an error item and drops all work; the loop then goes
on serving new requests.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.observability.flight import CRASH
from dynamo_tpu_torch.protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.tracing import Span, record_span, trace_of

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
        drained = 0
        while True:
            try:
                _req, _ctx, out_q, _t_enq = self._intake.get_nowait()
            except asyncio.QueueEmpty:
                break
            out_q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            out_q.put_nowait(_SENTINEL)
            drained += 1
        if drained:
            self.core.flight.record(CRASH, where="intake_drain", drained=drained)

    # -- engine loop -------------------------------------------------------

    async def _engine_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            admitted = False
            while True:
                try:
                    request, context, out_q, t_enq = self._intake.get_nowait()
                except asyncio.QueueEmpty:
                    break
                # Intake to the engine loop: the request's wait for the loop
                # (the scheduler queue's wait on the timeline).
                record_span("engine_queue_wait", (time.perf_counter() - t_enq) * 1e3, trace=trace_of(context),
                            request_id=context.id)
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
                if FAULTS.armed:
                    FAULTS.fire("engine.step")
                outputs = await loop.run_in_executor(None, self.core.step)
            except Exception as exc:
                logger.exception("engine step failed; failing all in-flight streams")
                try:
                    self.core.flight.record(CRASH, where="engine_loop", error=type(exc).__name__,
                                            detail=str(exc)[:500], streams=len(self._streams))
                    path = self.core.flight.dump_jsonl(reason="engine_step_failure")
                    logger.error("flight recorder dumped to %s", path)
                except Exception:
                    logger.exception("flight recorder dump failed")
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
        await self._intake.put((request, context, out_q, time.perf_counter()))
        self._wake.set()
        if self._closed:
            # close() may have run between the check above and the put.
            out_q.put_nowait(EngineOutput(token_ids=[], finish_reason=FinishReason.ERROR))
            out_q.put_nowait(_SENTINEL)
        finished = False
        span = Span("engine_request", trace=trace_of(context), request_id=request.request_id,
                    prompt_tokens=len(request.token_ids))
        span.__enter__()
        tokens_out = 0
        saw_finish = False
        try:
            while True:
                item = await out_q.get()
                if item is _SENTINEL:
                    finished = True
                    return
                if item.admission_wait_ms is not None:
                    # Arrival to scheduler admission, measured by the core
                    # and attached to the first delta.
                    record_span("engine_admission_wait", item.admission_wait_ms, trace=span.context,
                                request_id=request.request_id)
                if tokens_out == 0 and item.token_ids:
                    # TTFT at the engine boundary: submit to the first token
                    # out of the step loop. A child of engine_request.
                    record_span("engine_first_token", (time.perf_counter() - span.t0) * 1e3, trace=span.context,
                                request_id=request.request_id)
                tokens_out += len(item.token_ids)
                saw_finish = saw_finish or item.finish_reason is not None
                yield item.to_dict()
        finally:
            span.fields["output_tokens"] = tokens_out
            # A consumer may stop at the finish item without draining the
            # sentinel: that is still a completed request for the span.
            span.fields["finished"] = finished or saw_finish
            span.__exit__(None, None, None)
            if not finished:
                # Consumer walked away: stop the sequence so it doesn't
                # decode to max_tokens.
                context.stop_generating()
                self._wake.set()

    def metrics(self) -> ForwardPassMetrics:
        return self.core.metrics()
