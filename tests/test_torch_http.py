"""dynamo_tpu_torch's OpenAI HTTP frontend held against dynamo_tpu's (JAX) on the CPU.

Both packages serve test-tiny through ``run_local`` (discovery runtime,
model watcher, router, aiohttp service); the port's worker takes the JAX
worker's parameters through ``bridge.params_from_jax``. The same bodies go to
both, one at a time, and the answers must be equal once ``id`` and
``created`` are removed: greedy text and token counts bitwise, SSE chunk by
chunk, status codes and error bodies alike.
"""

import json

import aiohttp
import numpy as np

from dynamo_tpu.launch import run_local as jax_run_local
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.launch import run_local, shutdown

MODEL = "test-tiny"
STACK = dict(num_pages=64, max_batch_size=8)
# dynamo_frontend* families the port leaves out: the SLO accountant's
# streaming quantiles.
UNPORTED_FRONTEND_FAMILIES = {"dynamo_frontend_ttft_quantile_seconds", "dynamo_frontend_itl_quantile_seconds"}


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else np.asarray(v)) for k, v in tree.items()}


async def _stacks():
    jax = await jax_run_local(MODEL, port=0, **STACK)
    params = params_from_jax(_numpy_tree(jax["services"][0].core.runner.params), device="cpu")
    port = await run_local(MODEL, port=0, device="cpu", params=params, **STACK)
    return jax, port


async def _stop(jax, port):
    await shutdown(port)
    for closer in (jax["http"].stop, jax["watcher"].close, *(s.close for s in jax["services"]), jax["runtime"].close):
        await closer()


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in ("id", "created")} if isinstance(doc, dict) else doc


async def _call(session, base, method, path, body=None, *, data=None, headers=None):
    """(status, JSON body or SSE events with id/created removed, headers)."""
    async with session.request(method, base + path, json=body, data=data, headers=headers) as r:
        if r.content_type == "text/event-stream":
            events = []
            for line in (await r.text()).split("\n\n"):
                if line.startswith("data: "):
                    payload = line[len("data: "):]
                    events.append(payload if payload == "[DONE]" else _strip(json.loads(payload)))
            return r.status, events, r.headers
        if r.content_type == "application/json":
            return r.status, _strip(await r.json()), r.headers
        return r.status, await r.text(), r.headers


def _families(text: str, prefix: str = "dynamo_") -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE " + prefix)}


async def test_http_answers_equal_jax():
    jax, port = await _stacks()
    bases = [f"http://127.0.0.1:{h['port']}" for h in (jax, port)]
    chat = {"model": MODEL, "messages": [{"role": "user", "content": "What is 2+2?"}], "max_tokens": 12,
            "temperature": 0}
    completion = {"model": MODEL, "prompt": "abcdefghijklmnopqrstuvwxyz", "max_tokens": 16, "temperature": 0}
    usage = {"stream": True, "stream_options": {"include_usage": True}}
    calls = [
        ("GET", "/v1/models", None), ("GET", "/health", None), ("GET", "/live", None),
        ("POST", "/v1/chat/completions", chat),
        ("POST", "/v1/chat/completions", {**chat, **usage}),
        ("POST", "/v1/completions", completion),
        ("POST", "/v1/completions", {**completion, **usage, "prompt": "the port serves what the reference serves"}),
        ("POST", "/v1/completions", {**completion, "stop": [" W"]}),
        ("POST", "/clear_kv_blocks", None),
    ]
    trace_id = "4bf92f3577b34da6a3ce929d0e0736a1"
    traced = {"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"}
    try:
        async with aiohttp.ClientSession() as s:
            answers = [[await _call(s, base, m, path, body) for m, path, body in calls] for base in bases]
            for (m, path, body), (js, jdoc, _), (ts, tdoc, _) in zip(calls, *answers):
                assert (ts, tdoc) == (js, jdoc), (m, path, body)
                assert js == 200, (path, jdoc)
            by_call = dict(zip((c[1] + json.dumps(c[2]) for c in calls), answers[0]))
            text = by_call["/v1/completions" + json.dumps(completion)][1]["choices"][0]["text"]
            stopped = by_call["/v1/completions" + json.dumps({**completion, "stop": [" W"]})][1]["choices"][0]
            assert len(set(text)) > 4 and " W" in text  # a varied greedy text, which the stop string cuts
            assert stopped == {"index": 0, "text": text[: text.index(" W")], "finish_reason": "stop",
                               "logprobs": None}
            streamed = by_call["/v1/chat/completions" + json.dumps({**chat, **usage})][1]
            assert streamed[-1] == "[DONE]" and streamed[-2]["usage"]["completion_tokens"] == 12
            assert by_call["/clear_kv_blocks" + json.dumps(None)][1]["cleared"] >= 1
            assert by_call["/v1/models" + json.dumps(None)][1]["data"][0]["id"] == MODEL

            # traceparent: both continue the caller's trace; the port's span
            # ring answers /debug/traces for the request.
            for base in bases:
                body = {**completion, "max_tokens": 2, "request_id": "traced-request"}
                status, _, headers = await _call(s, base, "POST", "/v1/completions", body, headers=traced)
                assert status == 200 and headers["x-dynamo-trace-id"] == trace_id
            status, timeline, _ = await _call(s, bases[1], "GET", "/debug/traces/traced-request")
            assert status == 200 and timeline["trace_ids"] == [trace_id]
            assert {"http_request", "rpc_client"} <= {span["name"] for span in timeline["spans"]}

            metrics = []
            for base in bases:
                async with s.get(base + "/metrics") as r:
                    assert r.status == 200
                    metrics.append(await r.text())
        jfam, tfam = _families(metrics[0]), _families(metrics[1])
        assert tfam <= jfam  # no family of the port's own
        frontend = {f for f in jfam if f.startswith("dynamo_frontend")}
        assert UNPORTED_FRONTEND_FAMILIES <= frontend
        assert {f for f in tfam if f.startswith("dynamo_frontend")} == frontend - UNPORTED_FRONTEND_FAMILIES
    finally:
        await _stop(jax, port)


async def test_http_error_paths_equal_jax():
    """tests/test_http_frontend.py's error paths, plus routes the port leaves
    unregistered (404 there, where the JAX build answers)."""
    jax, port = await _stacks()
    calls = [
        ("/v1/chat/completions", {"json": {"messages": []}}, 400),  # no model
        ("/v1/chat/completions", {"json": {"model": "nope", "messages": [{"role": "user", "content": "x"}]}}, 404),
        ("/v1/chat/completions", {"data": b"{bad json"}, 400),
        ("/v1/completions", {"json": {"model": MODEL}}, 400),  # missing prompt
        ("/v1/completions", {"json": {"model": MODEL, "prompt": [1.5]}}, 400),  # bad prompt type
    ]
    try:
        async with aiohttp.ClientSession() as s:
            for path, kw, want in calls:
                got = []
                for h in (jax, port):
                    async with s.post(f"http://127.0.0.1:{h['port']}{path}", **kw) as r:
                        got.append((r.status, await r.json()))
                assert got[1] == got[0] and got[0][0] == want, (path, kw, got)
            for path in ("/v1/embeddings", "/engine/profile"):
                async with s.post(f"http://127.0.0.1:{port['port']}{path}", json={}) as r:
                    assert r.status == 404
    finally:
        await _stop(jax, port)
