"""The OpenAI-compatible aiohttp service (a copy of
``dynamo_tpu/frontend/http.py``; same routes, bodies, status codes and SSE
framing).

Routes (parity: reference `http/service/openai.rs`, `health.rs`,
`metrics.rs`, `clear_kv_blocks.rs`):

- POST /v1/chat/completions — streaming (SSE) and aggregated
- POST /v1/completions
- GET  /v1/models
- GET  /health, /live
- GET  /metrics — Prometheus text (the frontend registry)
- GET  /debug/traces/{request_id} — the assembled timeline of one request
  from this process's span ring
- POST /clear_kv_blocks — admin: drop prefix caches on all workers

Not registered yet, so they answer 404: ``/v1/embeddings`` (the engine's
encode path is not ported), and ``/debug/explain``, ``/debug/flight``,
``/debug/cost``, ``/debug/profile``, ``/debug/incidents``,
``/debug/federation``, ``/debug/store`` and ``/engine/profile``, which need
the worker telemetry plane, the incident store, the HA store or the device
profiler. Without worker telemetry, ``/metrics`` and ``/debug/traces`` serve
frontend-local data, as the JAX build does when no telemetry client is
wired.

Distributed tracing starts here: an incoming W3C ``traceparent`` header is
ingested (or a fresh trace minted), a root ``http_request`` span wraps the
request, and its context rides the per-request ``Context`` through every
pipeline stage.

Client disconnects cancel generation: the per-request Context is killed when
the response write fails or the request is torn down, and that propagates
through the pipeline to the engine scheduler.
"""

from __future__ import annotations

import asyncio
import logging
import sys
from typing import AsyncIterator, Awaitable, Callable

from aiohttp import web

from dynamo_tpu_torch.frontend.metrics import FrontendMetrics
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.frontend.openai_format import (
    SSE_DONE,
    ChatStream,
    CompletionStream,
    aggregate_chat,
    aggregate_completion,
    sse_encode,
)
from dynamo_tpu_torch.frontend.tool_calls import ToolCallStreamJail
from dynamo_tpu_torch.protocols.common import BackendOutput, FinishReason
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tracing import SPANS, Span, TraceContext

logger = logging.getLogger(__name__)


def _error(status: int, message: str, etype: str = "invalid_request_error") -> web.Response:
    return web.json_response({"error": {"message": message, "type": etype}}, status=status)


#: The structured SSE event a client sees when the engine dies mid-stream —
#: OpenAI error shape, no traceback, followed by [DONE] and a clean close.
_ENGINE_ERROR_EVENT = {
    "error": {
        "message": "the engine failed while generating this response",
        "type": "engine_error",
        "code": "mid_stream_failure",
    }
}


def assemble_timeline(request_id: str, spans: list[dict]) -> dict:
    """One ordered timeline from the union of span docs (a copy of
    ``dynamo_tpu/observability/service.py:assemble_timeline``).

    Spans from different processes share a trace_id but not a monotonic
    clock, so ordering uses the wall-clock ``start_ts``; ``offset_ms`` is
    relative to the earliest span (queue wait → router decision → prefill →
    KV phases → first decode step read top to bottom). ``children`` indexes
    restore the parent/child structure where ids link up. A span whose
    parent was evicted from the ring (span buffers are bounded) still
    surfaces at top level, flagged ``parent_evicted: true`` — orphans must
    never silently vanish from a postmortem.
    """
    spans = sorted(spans, key=lambda s: (s.get("start_ts") or 0.0, s.get("duration_ms") or 0.0))
    t0 = spans[0].get("start_ts", 0.0) if spans else 0.0
    by_id = {s.get("span_id"): i for i, s in enumerate(spans) if s.get("span_id")}
    out_spans = []
    for i, s in enumerate(spans):
        doc = dict(s)
        doc["offset_ms"] = round(((s.get("start_ts") or t0) - t0) * 1e3, 3)
        doc["children"] = [
            j for j, c in enumerate(spans) if c.get("parent_id") and c["parent_id"] == s.get("span_id")
        ]
        doc["root"] = s.get("parent_id") not in by_id or s.get("parent_id") is None
        if s.get("parent_id") is not None and s.get("parent_id") not in by_id:
            doc["parent_evicted"] = True
        out_spans.append(doc)
    trace_ids = sorted({s["trace_id"] for s in spans if s.get("trace_id")})
    return {
        "request_id": request_id,
        "trace_ids": trace_ids,
        "span_count": len(out_spans),
        "duration_ms": round(
            max(
                (s["offset_ms"] + (s.get("duration_ms") or 0.0) for s in out_spans),
                default=0.0,
            ),
            3,
        ),
        "spans": out_spans,
    }


class HttpService:
    def __init__(
        self,
        manager: ModelManager,
        *,
        metrics: FrontendMetrics | None = None,
        clear_kv_hook: Callable[[], Awaitable[int]] | None = None,
    ) -> None:
        self.manager = manager
        self.metrics = metrics or FrontendMetrics()
        self.clear_kv_hook = clear_kv_hook
        self._runner: web.AppRunner | None = None
        self.app = web.Application()
        self.app.add_routes(
            [
                web.post("/v1/chat/completions", self.chat_completions),
                web.post("/v1/completions", self.completions),
                web.get("/v1/models", self.list_models),
                web.get("/health", self.health),
                web.get("/live", self.live),
                web.get("/metrics", self.prometheus),
                web.get("/debug/traces/{request_id}", self.debug_traces),
                web.post("/clear_kv_blocks", self.clear_kv_blocks),
            ]
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        actual = self._runner.addresses[0][1] if self._runner.addresses else port
        logger.info("HTTP frontend listening on %s:%d", host, actual)
        return actual

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    # -- OpenAI endpoints --------------------------------------------------

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve_openai(request, kind="chat")

    async def completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve_openai(request, kind="completions")

    async def _serve_openai(self, request: web.Request, *, kind: str) -> web.StreamResponse:
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        model = body.get("model")
        if not isinstance(model, str):
            return _error(400, "missing 'model'")
        if kind == "chat" and not isinstance(body.get("messages"), list):
            return _error(400, "missing 'messages'")
        if kind == "completions" and "prompt" not in body:
            return _error(400, "missing 'prompt'")
        entry = self.manager.get(model)
        if (
            entry is None
            or (kind == "chat" and not entry.card.supports_chat)
            or (kind == "completions" and not entry.card.supports_completions)
        ):
            return _error(404, f"model '{model}' not found", "model_not_found")
        stream_mode = bool(body.get("stream", False))
        # OpenAI default: usage only when explicitly requested via stream_options.
        send_usage = bool((body.get("stream_options") or {}).get("include_usage", False))
        # Multi-tenant admission (dynamo_tpu/sched): tenant identity rides a
        # header (an API gateway stamps it; clients can't be trusted to);
        # priority is a plain body field. The preprocessor carries both into
        # PreprocessedRequest.
        tenant = request.headers.get("x-dynamo-tenant")
        if tenant:
            body["tenant_id"] = tenant
        else:
            # No gateway header: drop any client-supplied identity so a
            # client can't impersonate another tenant's quota (or hop to an
            # unconfigured tenant to dodge its own throttling).
            body.pop("tenant_id", None)
        ctx = Context(request_id=body.get("request_id"))
        # Trace ingress: continue the caller's W3C trace or mint a fresh one.
        # The root span's context rides ctx.trace through every pipeline
        # stage and process hop (GET /debug/traces/{ctx.id} reassembles it).
        incoming = TraceContext.from_traceparent(request.headers.get("traceparent"))
        root = Span("http_request", trace=incoming, request_id=ctx.id, model=model, endpoint=kind)
        ctx.trace = root.context.to_dict()
        root.__enter__()

        try:
            with self.metrics.tracker(model, kind) as tracker:
                try:
                    backend_stream = self._backend_stream(entry.pipeline, body, ctx, tracker)
                    if stream_mode:
                        return await self._stream_response(
                            request, model, kind, ctx, backend_stream, send_usage,
                            parse_tools=kind == "chat" and bool(body.get("tools")),
                            tracker=tracker,
                        )
                    if kind == "chat":
                        payload = await aggregate_chat(
                            model, backend_stream, parse_tools=bool(body.get("tools"))
                        )
                    else:
                        payload = await aggregate_completion(model, backend_stream)
                    choices = payload.get("choices") or []
                    if choices and choices[0].get("finish_reason") == "error":
                        # Engine died under the aggregation: headers aren't
                        # out yet, so a real HTTP error is still possible.
                        tracker.status = "error"
                        return _error(
                            502, "the engine failed while generating this response", "engine_error"
                        )
                    return web.json_response(
                        payload, headers={"x-dynamo-trace-id": root.trace_id}
                    )
                except asyncio.CancelledError:
                    ctx.kill()
                    raise
                except ValueError as exc:  # request-shape errors from the preprocessor
                    tracker.status = "invalid"
                    ctx.kill()
                    return _error(400, str(exc))
                except Exception:
                    logger.exception("request failed (model=%s)", model)
                    ctx.kill()
                    return _error(500, "internal error", "internal_error")
        finally:
            root.__exit__(*sys.exc_info())

    async def _backend_stream(self, pipeline, body, ctx: Context, tracker) -> AsyncIterator[BackendOutput]:
        tracker.on_dispatch()
        async for item in pipeline.generate(body, ctx):
            out = item if isinstance(item, BackendOutput) else BackendOutput.from_dict(item)
            tracker.on_token()
            if out.admission_wait_ms is not None:
                tracker.on_admission_wait(out.admission_wait_ms / 1e3)
            if out.finish_reason is not None:
                tracker.on_usage(out.prompt_tokens, out.cumulative_tokens, out.cached_tokens)
            yield out

    async def _stream_response(
        self, request: web.Request, model: str, kind: str, ctx: Context,
        backend_stream: AsyncIterator[BackendOutput], send_usage: bool,
        *, parse_tools: bool = False, tracker=None,
    ) -> web.StreamResponse:
        headers = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        }
        # Surface the trace id to the client on the stream too: with it (or
        # the request id) /debug/traces is reachable without grepping logs.
        trace_id = (ctx.trace or {}).get("trace_id") if isinstance(ctx.trace, dict) else None
        if trace_id:
            headers["x-dynamo-trace-id"] = str(trace_id)
        resp = web.StreamResponse(headers=headers)
        await resp.prepare(request)
        fmt = ChatStream(model, send_usage=send_usage) if kind == "chat" else CompletionStream(model, send_usage=send_usage)
        jail = None
        if parse_tools:
            jail = ToolCallStreamJail()
        try:
            if kind == "chat":
                await resp.write(sse_encode(fmt.first()))
            async for out in backend_stream:
                if out.finish_reason is FinishReason.ERROR and not out.token_ids:
                    # Mid-stream engine death: emit a structured OpenAI-style
                    # error event (never a traceback) and end the stream.
                    if tracker is not None:
                        tracker.status = "error"
                    await resp.write(sse_encode(_ENGINE_ERROR_EVENT))
                    break
                if jail is None:
                    await resp.write(sse_encode(fmt.delta(out)))
                    continue
                # Tools declared: hold back potential tool-call markup; on
                # the final delta decide between text and tool_calls finish.
                safe = jail.push(out.text) if out.text else ""
                if out.finish_reason is None:
                    if safe:
                        await resp.write(sse_encode(fmt.text_chunk(safe)))
                    continue
                trailing, calls = jail.finish()
                if calls:
                    if safe:
                        await resp.write(sse_encode(fmt.text_chunk(safe)))
                    await resp.write(sse_encode(fmt.tool_calls_final(calls, out)))
                else:
                    out.text = safe + trailing
                    await resp.write(sse_encode(fmt.delta(out)))
            await resp.write(SSE_DONE)
        except (ConnectionResetError, asyncio.CancelledError):
            logger.info("client disconnected; cancelling %s", ctx.id)
            ctx.kill()
            raise
        except Exception:
            # Headers are already on the wire: a JSON 500 is impossible. End
            # the SSE stream with an error event instead of a silent cut.
            logger.exception("stream failed mid-flight (model=%s)", model)
            ctx.kill()
            if tracker is not None:
                tracker.status = "error"
            try:
                await resp.write(sse_encode(_ENGINE_ERROR_EVENT))
                await resp.write(SSE_DONE)
            except (ConnectionResetError, OSError):
                pass
        finally:
            aclose = getattr(backend_stream, "aclose", None)
            if aclose:
                await aclose()
        await resp.write_eof()
        return resp

    # -- service endpoints -------------------------------------------------

    async def list_models(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {"id": c.name, "object": "model", "created": 0, "owned_by": "dynamo-tpu"}
                    for c in self.manager.cards()
                ],
            }
        )

    async def health(self, request: web.Request) -> web.Response:
        models = self.manager.names()
        status = "healthy" if models else "no_models"
        return web.json_response({"status": status, "models": models})

    async def live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def prometheus(self, request: web.Request) -> web.Response:
        self._sync_router_staleness()
        return web.Response(body=self.metrics.render(), content_type="text/plain")

    def _sync_router_staleness(self) -> None:
        """Fold every model's KvMetricsAggregator view into the staleness
        gauge (aggregators live in the model entries' aux lists)."""
        staleness: dict[int, float] = {}
        for name in self.manager.names():
            entry = self.manager.get(name)
            if entry is None:
                continue
            for a in entry.aux:
                fn = getattr(a, "staleness_seconds", None)
                if fn is not None:
                    staleness.update(fn())
        self.metrics.sync_staleness(staleness)

    async def debug_traces(self, request: web.Request) -> web.Response:
        """The assembled timeline for one request id from this process's
        span ring, deduped by span_id; a follow-up by trace_id catches spans
        recorded under a different request id."""
        rid = request.match_info["request_id"]
        spans = SPANS.query(request_id=rid)
        for tid in sorted({s.get("trace_id") for s in spans if s.get("trace_id")}):
            spans += SPANS.query(trace_id=tid)
        seen: set[str] = set()
        unique = []
        for s in spans:
            sid = s.get("span_id")
            if sid and sid in seen:
                continue
            if sid:
                seen.add(sid)
            unique.append(s)
        if not unique:
            return web.json_response(
                {"request_id": rid, "trace_ids": [], "span_count": 0, "spans": []}, status=404
            )
        return web.json_response(assemble_timeline(rid, unique))

    async def clear_kv_blocks(self, request: web.Request) -> web.Response:
        if self.clear_kv_hook is None:
            return web.json_response({"cleared": 0, "detail": "no workers wired"}, status=200)
        cleared = await self.clear_kv_hook()
        return web.json_response({"cleared": cleared})
