"""The port's flight recorder, fault points and engine spans on the CPU, held
against the JAX package (``tests/test_flight_slo.py`` and ``tests/test_chaos.py``
are the JAX side's own).

The ring's cases run on both packages' recorders with equal outputs; one
test-tiny serve through both engines gives STEP records equal on their
shared keys, and the JAX keys the port leaves out are pinned; an
``engine.step`` crash through both services leaves the same records, dump
and stream outcomes; ``sched.admit`` delays and drops admission as armed;
and a request leaves the JAX service's spans under its trace.
"""

import asyncio
import json

import numpy as np
import pytest

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.engine.service import JaxEngineService
from dynamo_tpu.mocker import build_mock_core
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.observability import flight as jflight
from dynamo_tpu.protocols import common as jcommon
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.tracing import SPANS as JSPANS
from dynamo_tpu_torch import blocks as tblocks
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import FLIGHT_KEYS_NOT_PORTED, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.engine.service import TorchEngineService
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.observability import flight as tflight
from dynamo_tpu_torch.protocols import common as tcommon
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime.engine import Context as TContext
from dynamo_tpu_torch.tracing import SPANS as TSPANS, TraceContext

NAME = "test-tiny"
PAGE = 4
ENGINE = dict(num_pages=48, page_size=PAGE, max_batch_size=4, max_prefill_tokens=64, max_seq_len=128,
              chunk_prefill_tokens=8)
JPARAMS = jllama.init_params(JPRESETS[NAME], 0)
PARAMS = params_from_jax({k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else np.asarray(v))
                          for k, v in JPARAMS.items()}, device="cpu")
# The STEP fields not held equal: measurements of this run (times, the
# record's stamp), the attention path in each package's own words (JAX's
# "fallback" is the port's "plain" on the CPU), and the ring position (the
# JAX ring also holds its compile tracker's records).
NOT_COMPARED = {"ts", "wall_ms", "dispatch_ms", "gap_ms", "attn_path", "seq"}


class _CostPlaneStub:
    """The JAX runner's device-cost registry as its STEP records read it,
    without the background compile thread (the suite turns the plane off,
    and with it the records' cost fields)."""

    def seen(self, program, key):
        return True

    def observe(self, *args, **kwargs):
        pass

    def take_step(self):
        return 0, 0

    def roofline_of(self, hbm_bytes, flops, seconds):
        return 0.0, "bytes"


@pytest.fixture(autouse=True)
def _disarmed():
    for reg in (jfaults.FAULTS, tfaults.FAULTS):
        reg.disarm()
    yield
    for reg in (jfaults.FAULTS, tfaults.FAULTS):
        reg.disarm()


def _req(common, prompt, n, **kw):
    return common.PreprocessedRequest(token_ids=list(prompt), sampling=common.SamplingOptions(temperature=0.0),
                                      stop=common.StopConditions(max_tokens=n, ignore_eos=True), **kw)


def _torch_core(**kw):
    runner = TorchModelRunner(PRESETS[NAME], PARAMS, num_pages=ENGINE["num_pages"], page_size=PAGE,
                              max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, device="cpu")
    return EngineCore(runner, EngineConfig(**{**ENGINE, **kw}))


def _unstamped(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "pid")} for r in records]


# -- the ring: both packages -------------------------------------------------


def ring_wraps(mod, tmp_path):
    ring = mod.FlightRecorder(capacity=4)
    for i in range(10):
        ring.record(mod.STEP, i=i)
    assert [r["seq"] for r in ring.snapshot()] == [6, 7, 8, 9]
    return _unstamped(ring.snapshot())


def ring_filters(mod, tmp_path):
    ring = mod.FlightRecorder(capacity=16)
    for i in range(6):
        ring.record(mod.STEP, i=i)
    ring.record(mod.CRASH, error="Boom")
    out = [_unstamped(ring.snapshot(kind=mod.CRASH)), _unstamped(ring.snapshot(kind=mod.STEP, last=2)),
           len(ring.snapshot(last=3)), len(ring)]
    ring.clear()
    return out + [len(ring)]


def ring_dump_explicit_path(mod, tmp_path):
    ring = mod.FlightRecorder(capacity=8)
    ring.record(mod.STEP, decode_rows=2)
    ring.record(mod.CRASH, error="RuntimeError", detail="boom")
    path = ring.dump_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"), reason="engine_step_failure")
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["kind"] == "dump_header" and lines[1:] == ring.snapshot()
    return _unstamped(lines)


def ring_dump_default_dir(mod, tmp_path):
    ring = mod.FlightRecorder(capacity=8)
    ring.record(mod.STEP)
    path = ring.dump_jsonl()
    assert path.startswith(str(tmp_path / "dumps"))
    return _unstamped(json.loads(line) for line in open(path))


def ring_capacity_env(mod, tmp_path):
    ring = mod.FlightRecorder()
    for i in range(5):
        ring.record(mod.STEP, i=i)
    return _unstamped(ring.snapshot())


RING_CASES = [ring_wraps, ring_filters, ring_dump_explicit_path, ring_dump_default_dir, ring_capacity_env]


@pytest.mark.parametrize("case", RING_CASES, ids=[f.__name__ for f in RING_CASES])
def test_flight_ring_equals_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_FLIGHT_DUMP_DIR", str(tmp_path / "dumps"))
    monkeypatch.setenv("DYN_FLIGHT_BUFFER", "3")
    assert case(tflight, tmp_path) == case(jflight, tmp_path)


# -- STEP records: both engines ----------------------------------------------


def test_step_records_equal_jax_on_shared_keys():
    """One test-tiny serve (mixed steps, a prefix hit) through both cores: a
    STEP record a step with equal shared fields; the port leaves out exactly
    FLIGHT_KEYS_NOT_PORTED (the device-cost plane's) and adds
    ``onboard_stalled``."""
    arrivals = [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9), (3, list(range(3, 19)) + list(range(40, 55)), 5)]
    jrunner = ModelRunner(JPRESETS[NAME], JPARAMS, num_pages=ENGINE["num_pages"], page_size=PAGE,
                          max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, attn_impl="reference")
    jrunner.cost_registry = _CostPlaneStub()

    def serve(core, common):
        for step in range(200):
            for at, prompt, n in arrivals:
                if at == step:
                    core.add_request(_req(common, prompt, n))
            if step > 3 and not core.has_work:
                break
            core.step()
        return core.flight.snapshot(kind="step")

    want = serve(JEngineCore(jrunner, JEngineConfig(**ENGINE)), jcommon)
    got = serve(_torch_core(), tcommon)
    assert len(got) == len(want) > 5
    jkeys, tkeys = set(want[0]), set(got[0])
    assert jkeys - tkeys == FLIGHT_KEYS_NOT_PORTED == {"hbm_bytes", "flops", "roofline_frac"}
    assert tkeys - jkeys == {"onboard_stalled"}
    shared = (jkeys & tkeys) - NOT_COMPARED
    assert [{k: r[k] for k in shared} for r in got] == [{k: r[k] for k in shared} for r in want]
    assert {r["step_kind"] for r in got} >= {"prefill", "mixed", "decode"}
    assert all(r["wall_ms"] >= r["dispatch_ms"] > 0 and r["attn_path"] == "plain" for r in got)
    assert sum(r["admitted"] for r in got) == 3 and not any(r["onboard_stalled"] for r in got)


# -- the engine.step fault point: both services ------------------------------


def _serve_through_crash(service, common, context_cls, faults, monkeypatch, tmp_path):
    """Arm ``engine.step:crash@3`` from DYN_FAULTS, stream one request into
    the crash, then one more after it."""
    monkeypatch.setenv("DYN_FAULTS", "engine.step:crash@3")
    monkeypatch.setenv("DYN_FLIGHT_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("DYN_INCIDENT_DIR", str(tmp_path / "incidents"))  # the JAX service's crash bundle
    faults.FAULTS.arm(__import__("os").environ["DYN_FAULTS"])

    async def main():
        try:
            crashed = [o async for o in service.generate(_req(common, range(1, 12), 8), context_cls())]
            after = [o async for o in service.generate(_req(common, range(20, 26), 5), context_cls())]
            return crashed, after
        finally:
            await service.close()

    crashed, after = asyncio.run(main())
    dumps = sorted(tmp_path.glob("flight-*.jsonl"))
    assert len(dumps) == 1
    lines = [json.loads(line) for line in open(dumps[0])]
    return crashed, after, lines, service.core


def test_engine_step_crash_records_dumps_and_recovers_like_jax(monkeypatch, tmp_path):
    """A crash injected before the third engine step: the JAX service (on
    its mock runner; the compositions are the port's) and the port's record
    two STEP records then one CRASH (``where="engine_loop"``), dump the ring
    to one JSONL file under DYN_FLIGHT_DUMP_DIR whose records are the ring's,
    end the stream with an error item, and serve the next request."""
    jsvc = JaxEngineService(build_mock_core(JEngineConfig(**ENGINE), realtime=False))
    tsvc = TorchEngineService(_torch_core())
    (jin, jafter, jlines, jcore) = _serve_through_crash(jsvc, jcommon, JContext, jfaults, monkeypatch,
                                                        tmp_path / "jax")
    (tin, tafter, tlines, tcore) = _serve_through_crash(tsvc, tcommon, TContext, tfaults, monkeypatch,
                                                        tmp_path / "torch")
    assert [o["finish_reason"] for o in tin] == [o["finish_reason"] for o in jin]
    assert tin[-1]["finish_reason"] == "error"
    assert sum(len(o["token_ids"]) for o in tin) == sum(len(o["token_ids"]) for o in jin) == 2
    assert [o["finish_reason"] for o in tafter][-1] == jafter[-1]["finish_reason"] == "length"
    assert sum(len(o["token_ids"]) for o in tafter) == sum(len(o["token_ids"]) for o in jafter) == 5
    for lines, core in ((tlines, tcore), (jlines, jcore)):
        header, records = lines[0], lines[1:]
        assert header["kind"] == "dump_header" and header["reason"] == "engine_step_failure"
        assert records == core.flight.snapshot()[:len(records)] and header["records"] == len(records)
    kinds = [r["kind"] for r in tlines[1:]]
    assert kinds == [r["kind"] for r in jlines[1:]] == ["step", "step", "crash"]
    tcrash, jcrash = tlines[-1], jlines[-1]
    assert {k: tcrash[k] for k in ("where", "error", "streams")} == {k: jcrash[k] for k in
                                                                    ("where", "error", "streams")}
    assert tcrash["error"] == "CrashFault" and "engine.step" in tcrash["detail"]
    assert tfaults.FAULTS.fired("engine.step") == 1
    assert tcore.allocator.stats().active_pages == 0 and not tcore.has_work


def test_step_crash_inside_the_core_records_its_context():
    """A step that raises inside the core (here its overlapped dispatch, with
    a chained step in flight) lands a CRASH record with the queues, free
    pages and the aborted in-flight rows before the exception propagates,
    as the JAX core does."""
    core = _torch_core(overlap=True)
    for i in range(3):
        core.add_request(_req(tcommon, range(1 + i, 25 + i), 16))
    for _ in range(8):
        core.step()
        if core._inflight is not None and core.overlap_step_counts["overlapped"]:
            break
    inflight = len(core._inflight.batch)

    def boom(*a, **k):
        raise RuntimeError("device array poisoned")

    core.runner.step_async = boom
    with pytest.raises(RuntimeError, match="poisoned"):
        core.step()
    crash = core.flight.snapshot(kind="crash")
    assert len(crash) == 1 and crash[0]["error"] == "RuntimeError" and crash[0]["inflight_rows"] == inflight
    assert {"waiting", "running", "prefilling", "free_pages", "last_step_info", "detail"} <= set(crash[0])
    assert core.flight.snapshot()[-1] is crash[0] and core.allocator.stats().active_pages == 0


# -- the sched.admit fault point ---------------------------------------------


def test_sched_admit_delay_and_drop(monkeypatch):
    """``sched.admit:delay`` sleeps DYN_FAULTS_DELAY_S at the admission seam
    and defers the head to the next step (nothing lost); ``drop`` cancels
    the request being admitted and the next one is served (JAX
    ``tests/test_chaos.py``'s drills)."""
    import time

    monkeypatch.setenv("DYN_FAULTS_DELAY_S", "0.2")
    core = _torch_core()
    tfaults.FAULTS.arm("sched.admit:delay@1")
    seqs = [core.add_request(_req(tcommon, [5, 6, 7], 4)) for _ in range(2)]
    t0 = time.perf_counter()
    assert core.step() == [] and time.perf_counter() - t0 >= 0.2
    assert len(core.waiting) == 2 and core.last_admission["admitted"] == 0 and not core.flight.snapshot()
    while core.has_work:
        core.step()
    assert tfaults.FAULTS.fired("sched.admit") == 1
    assert [s.finish_reason for s in seqs] == [tcommon.FinishReason.LENGTH] * 2
    assert core.flight.snapshot(kind="step")[0]["admitted"] == 2

    core = _torch_core()
    tfaults.FAULTS.arm("sched.admit:drop@1")
    a, b = (core.add_request(_req(tcommon, [1, 2, 3, 4], 4)) for _ in range(2))
    finished = {}
    while core.has_work:
        for seq, out in core.step():
            if out.finish_reason is not None:
                finished[seq.seq_id] = out.finish_reason
    assert finished == {a.seq_id: tcommon.FinishReason.CANCELLED, b.seq_id: tcommon.FinishReason.LENGTH}


# -- spans ---------------------------------------------------------------------


def _spans_of(service, common, context_cls, spans, trace):
    async def main():
        try:
            return [o async for o in service.generate(_req(common, range(1, 12), 4, request_id="req-1"),
                                                      context_cls(request_id="ctx-1", trace=trace.to_dict()))]
        finally:
            await service.close()

    outs = asyncio.run(main())
    return outs, {s["name"]: s for s in spans.query(trace_id=trace.trace_id)}


def test_engine_spans_equal_jax_names_and_fields(tmp_path):
    """A request with a trace leaves engine_queue_wait, engine_admission_wait,
    engine_first_token and engine_request under its trace id, with the JAX
    service's fields and parent links; a background tier onboarding leaves
    engine_onboard_wait under the request's trace."""
    trace = TraceContext.new()
    jouts, jspans = _spans_of(JaxEngineService(build_mock_core(JEngineConfig(**ENGINE), realtime=False)),
                              jcommon, JContext, JSPANS, trace)
    touts, tspans = _spans_of(TorchEngineService(_torch_core()), tcommon, TContext, TSPANS, trace)
    names = {"engine_queue_wait", "engine_admission_wait", "engine_first_token", "engine_request"}
    assert set(tspans) == set(jspans) == names
    for name in names:
        assert set(tspans[name]) == set(jspans[name]), name
        for key in ("request_id", "prompt_tokens", "output_tokens", "finished", "status"):
            assert tspans[name].get(key) == jspans[name].get(key), (name, key)
    req = tspans["engine_request"]
    assert req["parent_id"] == trace.span_id and req["output_tokens"] == 4 and req["finished"] is True
    for child in ("engine_first_token", "engine_admission_wait"):
        assert tspans[child]["parent_id"] == req["span_id"]
    assert tspans["engine_queue_wait"]["request_id"] == "ctx-1" and tspans["engine_first_token"]["duration_ms"] > 0

    # engine_onboard_wait: a prefix pushed out of a 6-page pool into G2 comes
    # back through a background session.
    runner = TorchModelRunner(PRESETS[NAME], PARAMS, num_pages=7, page_size=PAGE, max_batch_size=4,
                              prefill_bucket=16, device="cpu")
    bm = tblocks.KvBlockManager(tblocks.BlockManagerConfig(g2_capacity_blocks=16, g3_path=tmp_path / "g3"),
                                read_page=runner.read_page, write_page=runner.write_page,
                                write_pages=runner.write_pages)
    core = EngineCore(runner, EngineConfig(num_pages=7, page_size=PAGE, max_batch_size=4, max_prefill_tokens=256,
                                           max_seq_len=128, async_onboard=True), block_manager=bm)
    pa = list(range(1, 13))
    for i, prompt in enumerate((pa, [50 + i for i in range(12)], [80 + i for i in range(12)], pa)):
        core.add_request(_req(tcommon, prompt, 3, request_id=f"tier-{i}"), TContext(trace=trace.to_dict()))
        while core.has_work:
            core.step()
    (onboard,) = [s for s in TSPANS.query(trace_id=trace.trace_id) if s["name"] == "engine_onboard_wait"]
    assert onboard["request_id"] == "tier-3" and onboard["pages"] >= 2 and onboard["parent_id"] == trace.span_id
    assert {"name", "trace_id", "span_id", "parent_id", "duration_ms", "status", "request_id", "pages"} <= set(onboard)
