"""dynamo_tpu_torch's KV router held against dynamo_tpu's (JAX) on the CPU.

The indexers and schedulers of both packages take the same seeded event
streams and load snapshots and must agree on every score, cost and choice;
the block hashes the router looks up must be the ones the port's engine and
the JAX engine publish; and the two-worker KV scenario of the JAX router's
end-to-end test runs on the port's ``run_local``.
"""

import threading

import aiohttp
import numpy as np
import pytest

from conftest import wait_for
from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu.protocols.kv import ForwardPassMetrics as JMetrics
from dynamo_tpu.protocols.kv import RouterEvent as JRouterEvent
from dynamo_tpu.router.indexer import KvIndexer as JIndexer
from dynamo_tpu.router.scheduler import KvScheduler as JScheduler, SchedulerConfig as JSchedulerConfig
from dynamo_tpu.tokens import compute_block_hashes as jax_block_hashes
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.launch import run_local, shutdown
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics, RouterEvent
from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.router import KvRouter
from dynamo_tpu_torch.router.scheduler import KvScheduler, SchedulerConfig
from dynamo_tpu_torch.tokens import compute_block_hashes

PAGE = 16


def _event_stream(rng: np.random.Generator, workers: list[int]) -> list[dict]:
    """Seeded RouterEvent dicts: each worker stores the prefix chains of a few
    prompts (some shared between workers, so overlaps differ), then drops
    some blocks; one worker is cleared and restocked."""
    prompts = [rng.integers(0, 300, size=int(rng.integers(PAGE, 8 * PAGE))).tolist() for _ in range(6)]
    events = []
    for _ in range(40):
        wid = int(rng.choice(workers))
        chain = jax_block_hashes(prompts[int(rng.integers(len(prompts)))], PAGE)
        n = int(rng.integers(1, len(chain) + 1))
        parents = [None] + chain[:-1]
        if rng.random() < 0.75:
            stored = [{"block_hash": h, "parent_hash": p, "token_ids": []} for h, p in zip(chain[:n], parents[:n])]
            events.append({"worker_id": wid, "event": {"stored": stored, "removed": [], "cleared": False}})
        else:
            removed = [{"block_hash": h} for h in chain[n - 1:]]
            events.append({"worker_id": wid, "event": {"stored": [], "removed": removed, "cleared": False}})
    events.insert(len(events) // 2, {"worker_id": workers[0], "event": {"stored": [], "removed": [], "cleared": True}})
    return events, prompts


@pytest.mark.parametrize("seed,n_workers", [(0, 2), (1, 3), (2, 4)])
def test_indexer_and_scheduler_agree_with_jax(seed, n_workers):
    rng = np.random.default_rng(seed)
    workers = [0x10 + 7 * i for i in range(n_workers)]
    events, prompts = _event_stream(rng, workers)
    jidx, tidx = JIndexer(), KvIndexer()
    for ev in events:
        jidx.apply_event(JRouterEvent.from_dict(ev))
        tidx.apply_event(RouterEvent.from_dict(ev))
    assert tidx.worker_block_counts() == jidx.worker_block_counts()
    assert tidx.num_blocks == jidx.num_blocks and tidx.events_applied == jidx.events_applied
    queries = prompts + [p[: len(p) // 2] + [7] * PAGE for p in prompts]
    nonzero = 0
    for temperature in (0.0, 0.5):
        jsched = JScheduler(JSchedulerConfig(temperature=temperature, seed=seed))
        tsched = KvScheduler(SchedulerConfig(temperature=temperature, seed=seed))
        for q in queries:
            hashes = compute_block_hashes(q, PAGE)
            assert hashes == jax_block_hashes(q, PAGE)
            jov, tov = jidx.find_matches(hashes), tidx.find_matches(hashes)
            assert tov.scores == jov.scores and tov.best() == jov.best()
            nonzero += bool(jov.scores)
            snap = {w: dict(kv_active_blocks=int(rng.integers(0, 64)), kv_total_blocks=64,
                            num_requests_waiting=int(rng.integers(0, 4)), request_total_slots=8,
                            num_requests_running=int(rng.integers(0, 8))) for w in workers}
            jm = {w: JMetrics(worker_id=w, **m) for w, m in snap.items()}
            tm = {w: ForwardPassMetrics(worker_id=w, **m) for w, m in snap.items()}
            n = max(len(hashes), 1)
            assert tsched.costs(n, tov, tm, workers) == jsched.costs(n, jov, jm, workers)
            assert tsched.schedule(n, tov, tm, workers) == jsched.schedule(n, jov, jm, workers)
    assert nonzero > len(queries) // 2  # the streams left overlaps to score


def _committed_hashes(core, make_request, prompt: list[int]) -> list[int]:
    core.add_request(make_request(prompt))
    while core.has_work:
        core.step()
    return [s.block_hash for ev in core.events for s in ev.stored]


def test_router_hashes_are_the_engines_committed_hashes():
    """The router looks up what both engines publish as they commit pages."""
    prompt = list(range(5, 5 + 3 * PAGE + 5))  # three full pages and a partial one
    engine = dict(num_pages=32, page_size=PAGE, max_batch_size=2, max_seq_len=128, eos_token_ids=(257,))
    jparams = jllama.init_params(JPRESETS["test-tiny"], 0)
    jrunner = ModelRunner(JPRESETS["test-tiny"], jparams, num_pages=32, page_size=PAGE, max_batch_size=2,
                          prefill_bucket=16, attn_impl="reference")
    tparams = params_from_jax({k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                                   else np.asarray(v)) for k, v in jparams.items()}, device="cpu")
    trunner = TorchModelRunner(PRESETS["test-tiny"], tparams, num_pages=32, page_size=PAGE, max_batch_size=2,
                               prefill_bucket=16, device="cpu")
    jcore = JEngineCore(jrunner, JEngineConfig(**engine), on_kv_event=lambda e: jcore.events.append(e))
    tcore = EngineCore(trunner, EngineConfig(**engine), on_kv_event=lambda e: tcore.events.append(e))
    jcore.events, tcore.events = [], []
    want = _committed_hashes(jcore, lambda p: JRequest(token_ids=p, sampling=JSampling(temperature=0.0),
                                                       stop=JStop(max_tokens=2)), prompt)
    got = _committed_hashes(tcore, lambda p: PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                                                 stop=StopConditions(max_tokens=2)), prompt)
    router = KvRouter(KvIndexer(), KvScheduler(), None, block_size=PAGE)
    for ev in tcore.events:
        router.indexer.apply_event(RouterEvent(1, ev))
    assert len(want) >= 3 and got == want
    assert compute_block_hashes(prompt, PAGE) == want[:3]
    assert router.schedule(prompt, [1, 2]) == (1, 3)  # the worker that committed them, all three blocks


async def test_kv_routed_repeat_prompt_hits_cache():
    """tests/test_router_e2e.py's two-worker scenario on the port: KV events
    from the engine steps (run in the executor thread) reach the router's
    indexer, and a repeat prompt goes to the worker holding its blocks."""
    handles = await run_local("test-tiny", port=0, num_workers=2, router_mode="kv", device="cpu",
                              num_pages=64, max_batch_size=8)
    base = f"http://127.0.0.1:{handles['port']}"
    emit_threads = set()
    for svc in handles["services"]:
        publish = svc.core.allocator._on_event
        svc.core.allocator._on_event = lambda ev, publish=publish: (emit_threads.add(threading.get_ident()),
                                                                    publish(ev))
    try:
        entry = handles["http"].manager.get("test-tiny")
        assert entry is not None and entry.aux, "kv router stack should be built"
        body = {"model": "test-tiny", "prompt": "a" * 48, "max_tokens": 4, "temperature": 0}
        async with aiohttp.ClientSession() as s:
            async with s.post(base + "/v1/completions", json=body) as r:
                assert r.status == 200, await r.text()
                first = await r.json()
            indexer = entry.aux[0].indexer
            assert await wait_for(lambda: indexer.num_blocks >= 3), "indexer never saw KV events"
            assert emit_threads and threading.get_ident() not in emit_threads  # published off the loop
            counts_before = indexer.worker_block_counts()
            (hot_worker,) = [w for w, c in counts_before.items() if c >= 3]
            served_by = {svc.core.config.worker_id: svc for svc in handles["services"]}
            hits_before = served_by[hot_worker].core.allocator.stats().hits
            async with s.post(base + "/v1/completions", json=body) as r:
                assert r.status == 200
                second = await r.json()
            assert second["choices"][0]["text"] == first["choices"][0]["text"]
            assert second["usage"]["prompt_tokens_details"]["cached_tokens"] >= 32
            assert served_by[hot_worker].core.allocator.stats().hits > hits_before
            other = {"model": "test-tiny", "prompt": "z" * 48, "max_tokens": 4, "temperature": 0}
            async with s.post(base + "/v1/completions", json=other) as r:
                assert r.status == 200
            await wait_for(lambda: len([c for c in indexer.worker_block_counts().values() if c]) == 2, timeout=3.0)
            counts_after = indexer.worker_block_counts()
            assert sum(counts_after.values()) > counts_before.get(hot_worker, 0)
    finally:
        await shutdown(handles)
