"""The port's SLO admission plane (``dynamo_tpu_torch/sched/``), cache-aware
admission and the router's attainment and cache-aware cost terms, held
against the JAX package on the CPU (``tests/test_slo_sched.py`` and
``tests/test_cache_aware.py`` are the JAX side's own).

The predictor, tenant registry, admission and chunk-budget controllers run
the JAX tests' scenarios on both packages' classes, with an injected clock:
every return value and counter equal. Router costs are equal bit for bit.
Both engines serve test-tiny with ``slo_sched`` (then ``cache_aware`` and a
G2 tier) under one fake clock that the runners advance by a fixed amount a
dispatch: the admission order, ``last_admission`` a step, the throttle and
deferral counts, the chunk budgets and the greedy tokens are equal.
"""

import asyncio
import time
import types
from collections import deque

import numpy as np
import pytest

import dynamo_tpu.config as jconfig
import dynamo_tpu.engine.core as jcore_mod
import dynamo_tpu.sched as jsched
from dynamo_tpu import blocks as jblocks
from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.engine.sequence import Sequence as JSequence
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.planner.core import WorkerProfile as JWorkerProfile
from dynamo_tpu.protocols import common as jcommon
from dynamo_tpu.protocols.kv import ForwardPassMetrics as JMetrics
from dynamo_tpu.router import scheduler as jrouter
from dynamo_tpu.router.indexer import OverlapScores as JOverlap
from dynamo_tpu.runtime.engine import Context as JContext
import dynamo_tpu_torch.config as tconfig
import dynamo_tpu_torch.engine.core as tcore_mod
import dynamo_tpu_torch.sched as tsched
from dynamo_tpu_torch import blocks as tblocks
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.engine.sequence import Sequence as TSequence
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.planner.core import WorkerProfile as TWorkerProfile
from dynamo_tpu_torch.protocols import common as tcommon
from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics as TMetrics
from dynamo_tpu_torch.router import scheduler as trouter
from dynamo_tpu_torch.router.indexer import OverlapScores as TOverlap
from dynamo_tpu_torch.runtime.engine import Context as TContext

JAX = types.SimpleNamespace(sched=jsched, config=jconfig, Sequence=JSequence, common=jcommon, Context=JContext,
                            WorkerProfile=JWorkerProfile, router=jrouter, Overlap=JOverlap, Metrics=JMetrics)
TORCH = types.SimpleNamespace(sched=tsched, config=tconfig, Sequence=TSequence, common=tcommon, Context=TContext,
                              WorkerProfile=TWorkerProfile, router=trouter, Overlap=TOverlap, Metrics=TMetrics)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _req(P, tokens, *, tenant=None, priority=0, max_tokens=4):
    c = P.common
    return c.PreprocessedRequest(token_ids=list(tokens), sampling=c.SamplingOptions(temperature=0.0),
                                 stop=c.StopConditions(max_tokens=max_tokens, ignore_eos=True),
                                 tenant_id=tenant, priority=priority)


def _seq(P, seq_id, n_tokens, *, arrival, tenant=None, priority=0):
    seq = P.Sequence.from_request(seq_id, _req(P, range(1, n_tokens + 1), tenant=tenant, priority=priority),
                                  P.Context(), page_size=16, salt=0)
    seq.arrival_time = arrival
    return seq


def _ctl(P, clk, *, budget=0.5, stretch=2.0, quotas=None, cached_fn=None, **pred_kw):
    s = P.sched
    tenants = s.TenantRegistry(clock=clk)
    for tenant, q in (quotas or {}).items():
        tenants.configure(tenant, s.TenantQuota(**q))
    ctl = s.AdmissionController(s.AdmissionConfig(ttft_budget_s=budget, tier_stretch=stretch),
                                predictor=s.TtftPredictor(**pred_kw), tenants=tenants, clock=clk)
    ctl.cached_tokens_fn = cached_fn
    return ctl


def _ids(waiting):
    return [s.seq_id for s in waiting]


# -- the plane's classes: the JAX tests' scenarios on both packages ----------


def sc_edf_by_slack(P):
    clk = _Clock()
    ctl = _ctl(P, clk)
    relaxed = _seq(P, 0, 200, arrival=0.0, priority=1)
    urgent = _seq(P, 1, 20, arrival=0.1)
    waiting = deque([relaxed, urgent])
    n = ctl.prepare(waiting, running=0, slots=8)
    assert n == 2 and _ids(waiting) == [1, 0]
    return [n, _ids(waiting), [s.predicted_ttft_s for s in waiting], [s.predicted_at for s in waiting],
            ctl.last_slack_ms]


def sc_tie_break_on_arrival(P):
    ctl = _ctl(P, _Clock())
    waiting = deque([_seq(P, 5, 32, arrival=0.5), _seq(P, 3, 32, arrival=0.0, priority=1)])
    ctl.prepare(waiting, running=0, slots=8)
    assert _ids(waiting) == [3, 5]
    return [_ids(waiting), ctl.last_slack_ms]


def sc_tier_clamp(P):
    ctl = _ctl(P, _Clock())
    tiers = [ctl.tier_of(_seq(P, i, 4, arrival=0.0, priority=p)) for i, p in enumerate((-3, 0, 2, 99))]
    assert tiers == [0, 0, 2, ctl.config.max_tier]
    waiting = [_seq(P, i, 4, arrival=0.0, priority=p) for i, p in enumerate((1, 1, 0, 7))]
    return [tiers, ctl.queue_depth_by_tier(waiting), [ctl.deadline(s) for s in waiting]]


def sc_heavy_throttled_light_not(P):
    clk = _Clock()
    ctl = _ctl(P, clk, quotas={"heavy": dict(rate_tokens_per_s=100.0, burst_tokens=100.0)})
    heavies = [_seq(P, i, 100, arrival=i * 1e-3, tenant="heavy", priority=1) for i in range(10)]
    lights = [_seq(P, 100 + i, 10, arrival=0.02 + i * 1e-3) for i in range(4)]
    waiting = deque(heavies + lights)
    out = [ctl.prepare(waiting, running=0, slots=32), _ids(waiting)]
    head = list(waiting)[:out[0]]
    assert out[0] == 5 and ctl.tenants.throttled == {"heavy": 9}
    for s in head:
        ctl.on_admit(s, clk())
    rest = deque(s for s in heavies if s not in head)
    out.append(ctl.prepare(rest, running=5, slots=32))
    clk.t += 1.0
    out += [ctl.prepare(rest, running=5, slots=32), _ids(rest)]
    assert out[2:4] == [0, 1]
    return out + [dict(ctl.tenants.throttled), ctl.throttle_events, ctl.admitted_total, ctl.deadline_misses,
                  [bool(s.quota_deferred) for s in heavies], ctl.tenants.inflight("heavy")]


def sc_inflight_cap_never_wedges(P):
    reg = P.sched.TenantRegistry(clock=_Clock())
    reg.configure("t", P.sched.TenantQuota(max_inflight_tokens=50))
    out = [reg.would_admit("t", 80)]
    reg.on_admit("t", 80)
    out += [reg.inflight("t"), reg.would_admit("t", 10)]
    reg.on_finish("t", 80)
    out += [reg.inflight("t"), reg.would_admit("t", 10)]
    assert out == [True, 80, False, 0, True]
    return out


def sc_charges_once_across_preemption(P):
    clk = _Clock()
    ctl = _ctl(P, clk, quotas={"t": dict(rate_tokens_per_s=100.0, burst_tokens=100.0)})
    reg = ctl.tenants
    seq = _seq(P, 1, 60, arrival=0.0, tenant="t")
    ctl.on_admit(seq, 0.0)
    level = reg._bucket_level("t", reg.quota("t"))
    ctl.on_admit(seq, 0.0)
    out = [level, reg._bucket_level("t", reg.quota("t")), reg.inflight("t")]
    ctl.on_finish(seq)
    ctl.on_finish(seq)
    assert out[0] == out[1] and out[2] == 60 and reg.inflight("t") == 0
    return out + [reg.inflight("t"), ctl.admitted_total]


def sc_preempted_resume_bypasses_gate(P):
    ctl = _ctl(P, _Clock(), quotas={"t": dict(rate_tokens_per_s=10.0, burst_tokens=60.0, max_inflight_tokens=80)})
    seq = _seq(P, 1, 60, arrival=0.0, tenant="t")
    ctl.on_admit(seq, 0.0)
    out = [ctl.prepare(deque([seq]), running=0, slots=8), dict(ctl.tenants.throttled)]
    waiting = deque([seq, _seq(P, 2, 60, arrival=0.0, tenant="t")])
    out += [ctl.prepare(waiting, running=0, slots=8), _ids(waiting), dict(ctl.tenants.throttled)]
    assert out[:2] == [1, {}] and out[2:4] == [1, [1, 2]]
    return out


def sc_observe_from_prediction_time(P):
    clk = _Clock()
    ctl = _ctl(P, clk)
    seq = _seq(P, 1, 40, arrival=0.0)
    clk.t = 5.0
    ctl.prepare(deque([seq]), running=0, slots=8)
    clk.t = 5.4
    ctl.on_first_token(seq)
    assert seq.predicted_at == 5.0 and ctl.predictor.observations == 1
    return [seq.predicted_ttft_s, seq.predicted_at, ctl.predictor.bias, ctl.predictor.observations]


def sc_registry_from_settings(P):
    reg = P.sched.TenantRegistry.from_settings(P.config.TenantSettings(
        rate_tokens_per_s=10.0, max_inflight_tokens=300,
        quotas='{"heavy": {"rate_tokens_per_s": 1000, "burst_tokens": 500, "weight": 2}, "light": {}}'))
    out = [(q.rate_tokens_per_s, q.burst_tokens, q.max_inflight_tokens, q.weight, q.capacity)
           for q in (reg.quota("anyone"), reg.quota("heavy"), reg.quota("light"))]
    assert out[1] == (1000.0, 500.0, 300, 2.0, 500.0)
    return out


def sc_chunk_hysteresis(P):
    ctl = P.sched.ChunkBudgetController(512, itl_budget_ms=50.0, floor_tokens=64, shrink_at=0.9, relax_at=0.5,
                                        cooldown_steps=2, window=16, min_samples=4)
    trace = []
    for ms in [60.0] * 50 + [30.0] * 20 + [10.0] * 80:
        ctl.observe(ms)
        trace.append((ctl.budget(), ctl.tail_ms()))
    assert ctl.budget() == 512 and (ctl.shrinks, ctl.relaxes) == (3, 3) and min(b for b, _ in trace) == 64
    with pytest.raises(ValueError):
        P.sched.ChunkBudgetController(0)
    return [trace, ctl.shrinks, ctl.relaxes]


def sc_predictor(P):
    p = P.sched.TtftPredictor()
    out = [p.predict(queued_tokens=n, running=0, slots=8) for n in (100, 10000)]
    for _ in range(50):
        p.observe(out[0], 2 * out[0])
    out += [p.bias, p.predict(queued_tokens=100, running=0, slots=8)]
    p2 = P.sched.TtftPredictor()
    for pred, actual in ((0.001, 1000.0), (None, 1.0), (0.0, 1.0)):
        p2.observe(pred, actual)
    for _ in range(40):
        p2.observe(1.0, 1e-6)  # each ratio clamps to 1/8 before the average
    out += [p2.bias, p2.observations]
    assert 0.125 <= p2.bias < 0.13 and p2.observations == 41
    prof = P.WorkerProfile(prefill_tokens_per_sec=10000.0, ttft_p99_curve=[(0.0, 0.1), (1.0, 0.5)])
    p3 = P.sched.TtftPredictor(prof)
    out += [p3.predict(queued_tokens=1000, running=r, slots=10) for r in (0, 5, 10, 20)]
    return out


def sc_residual_pricing(P):
    cached = {0: 2850, 1: 0}
    out = []
    for priced in (True, False):
        ctl = _ctl(P, _Clock(2.0), cached_fn=(lambda s: cached[s.seq_id]) if priced else None,
                   quotas={"bulk": dict(max_inflight_tokens=600)})
        ctl.tenants.on_admit("bulk", 400)
        waiting = deque([_seq(P, 1, 300, arrival=0.2), _seq(P, 0, 3000, arrival=0.0, tenant="bulk")])
        out.append((ctl.prepare(waiting, running=0, slots=8), _ids(waiting), ctl.last_slack_ms))
    assert [o[:2] for o in out] == [(2, [0, 1]), (1, [1, 0])]
    ctl = _ctl(P, _Clock(), cached_fn=lambda s: 2850)
    seq = _seq(P, 7, 3000, arrival=0.0, tenant="acme")
    ctl.on_admit(seq)
    out += [ctl._charges[7], ctl.tenants.inflight("acme")]
    ctl.on_finish(seq)
    ctl.cached_tokens_fn = lambda s: 10**9
    ctl.on_admit(_seq(P, 8, 4, arrival=0.0, tenant="acme"))
    out.append(ctl._charges[8])

    def boom(seq):
        raise RuntimeError("indexer down")

    ctl = _ctl(P, _Clock(), cached_fn=boom)
    seq = _seq(P, 3, 40, arrival=0.0, tenant="t")
    out.append(ctl.prepare(deque([seq]), running=0, slots=8))
    ctl.on_admit(seq)
    out.append(ctl._charges[3])
    assert out[2:] == [("acme", 150), 150, ("acme", 1), 1, ("t", 40)]
    return out


SCENARIOS = [sc_edf_by_slack, sc_tie_break_on_arrival, sc_tier_clamp, sc_heavy_throttled_light_not,
             sc_inflight_cap_never_wedges, sc_charges_once_across_preemption, sc_preempted_resume_bypasses_gate,
             sc_observe_from_prediction_time, sc_registry_from_settings, sc_chunk_hysteresis, sc_predictor,
             sc_residual_pricing]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_plane_scenarios_equal_jax(scenario):
    assert scenario(TORCH) == scenario(JAX)


# -- settings, builders and the router's cost terms --------------------------


def test_builders_read_the_same_settings(tmp_path, monkeypatch):
    prof = tmp_path / "profile.json"
    prof.write_text(JWorkerProfile(prefill_tokens_per_sec=12345.0, ttft_p99_curve=[(0.0, 0.2), (1.0, 0.9)]).to_json())
    for key, val in {"DYN_SLO_SCHED_TTFT_BUDGET_MS": "200", "DYN_SLO_SCHED_TIER_STRETCH": "3",
                     "DYN_SLO_SCHED_PROFILE": str(prof), "DYN_SLO_SCHED_CHUNK_FLOOR_TOKENS": "16",
                     "DYN_SLO_SCHED_CHUNK_COOLDOWN_STEPS": "3", "DYN_SLO_ITL_P99_MS": "25",
                     "DYN_TENANT_RATE_TOKENS_PER_S": "123",
                     "DYN_TENANT_QUOTAS": '{"heavy": {"max_inflight_tokens": 4096}}'}.items():
        monkeypatch.setenv(key, val)

    def built(P):
        ctl = P.sched.build_admission_controller()
        ch = P.sched.build_chunk_controller(256)
        t = ctl.tenants
        return [ctl.config.ttft_budget_s, ctl.config.tier_stretch, ctl.predictor.profile.prefill_tokens_per_sec,
                ctl.predictor.predict(queued_tokens=500, running=3, slots=8),
                (t.default_quota.rate_tokens_per_s, t.quota("heavy").max_inflight_tokens),
                (ch.base, ch.floor, ch.itl_budget_ms, ch.cooldown_steps, ch.shrink_at, ch.relax_at)]

    got, want = built(TORCH), built(JAX)
    assert got == want and got[0] == 0.2 and got[5][:3] == (256, 16, 25.0)


ENVS = [{}, {"DYN_SLO_SCHED": "1"}, {"DYN_CACHE_AWARE": "1"},
        {"DYN_SLO_SCHED": "1", "DYN_CACHE_AWARE": "1", "DYN_SLO_SCHED_ATTAINMENT_WEIGHT": "2.5",
         "DYN_SLO_SCHED_TTFT_BUDGET_MS": "300", "DYN_CACHE_AWARE_WEIGHT": "0.5",
         "DYN_CACHE_AWARE_MAX_STALENESS_S": "3"},
        {"DYN_CACHE_AWARE": "on", "DYN_CACHE_AWARE_RATE_TOKENS_PER_S": "40000", "PROFILE": "1"},
        {"DYN_SLO_SCHED": "yes", "DYN_CACHE_AWARE": "1", "PROFILE": "1"}]


@pytest.mark.parametrize("env", ENVS, ids=[str(i) for i in range(len(ENVS))])
def test_configure_router_terms_equal_jax(env, tmp_path):
    """configure_attainment / configure_cache_aware arm the same SchedulerConfig
    fields from the same environment (a profile's prefill rate wins over the
    default rate, an explicit DYN_CACHE_AWARE_RATE_TOKENS_PER_S over both)."""
    env = dict(env)
    if env.pop("PROFILE", None):
        path = tmp_path / "p.json"
        path.write_text(JWorkerProfile(prefill_tokens_per_sec=7777.0).to_json())
        env["DYN_SLO_SCHED_PROFILE"] = str(path)

    def armed(P):
        cfg = P.router.SchedulerConfig()
        P.sched.configure_attainment(cfg, env)
        P.sched.configure_cache_aware(cfg, env, block_tokens=32)
        fields = ("attainment_weight", "ttft_slo_s", "cache_aware_weight", "cache_block_tokens",
                  "cache_rate_tokens_per_s", "cache_max_staleness_s")
        return [getattr(cfg, f) for f in fields] + [None if cfg.profile is None else cfg.profile.to_json(),
                                                    P.sched.slo_sched_enabled(env), P.sched.cache_aware_enabled(env)]

    got = armed(TORCH)
    assert got == armed(JAX)
    assert (got[0] > 0) == bool(env.get("DYN_SLO_SCHED")) and (got[2] > 0) == bool(env.get("DYN_CACHE_AWARE"))


ROUTER_CFGS = [dict(), dict(attainment_weight=1.0, ttft_slo_s=0.5, profile=True),
               dict(overlap_weight=0.0, cache_aware_weight=1.0, cache_block_tokens=16, ttft_slo_s=0.5,
                    cache_max_staleness_s=5.0),
               dict(overlap_weight=0.7, attainment_weight=2.5, ttft_slo_s=0.3, profile=True, cache_aware_weight=0.5,
                    cache_block_tokens=32, cache_rate_tokens_per_s=40000.0, cache_max_staleness_s=3.0)]


@pytest.mark.parametrize("cfg", ROUTER_CFGS, ids=["base", "attainment", "cache_aware", "both"])
def test_router_costs_equal_jax_bitwise(cfg):
    """KvScheduler.costs with the attainment and cache-aware terms, over
    random loads, overlaps and staleness (fresh, stale, missing): the same
    floats and the same pick as the JAX scheduler."""
    rng = np.random.default_rng(7)
    curve = [(0.0, 0.1), (0.5, 0.3), (1.0, 0.9)]
    workers = [1, 2, 3, 4, 5]
    for trial in range(40):
        n_blocks = int(rng.integers(1, 40))
        overlaps = {w: int(rng.integers(0, n_blocks + 3)) for w in workers if rng.random() < 0.7}
        loads = {w: (int(rng.integers(0, 9)), int(rng.integers(0, 5)), int(rng.integers(0, 64)))
                 for w in workers if rng.random() < 0.8}
        stale = None if trial % 3 == 0 else {w: float(rng.choice([0.0, 2.0, 4.0, 99.0])) for w in workers[:-1]}

        def costs(P):
            kw = {k: (P.WorkerProfile(ttft_p99_curve=curve) if k == "profile" else v) for k, v in cfg.items()}
            sched = P.router.KvScheduler(P.router.SchedulerConfig(**kw))
            metrics = {w: P.Metrics(kv_active_blocks=a, kv_total_blocks=64, num_requests_running=r,
                                    num_requests_waiting=q, request_total_slots=8)
                       for w, (r, q, a) in loads.items()}
            c = sched.costs(n_blocks, P.Overlap(scores=dict(overlaps)), metrics, workers, staleness=stale)
            return c, sched.select(c)

        got, want = costs(TORCH), costs(JAX)
        assert got == want, trial


# -- the engines --------------------------------------------------------------

NAME = "test-tiny"
PAGE = 4
JPARAMS = jllama.init_params(JPRESETS[NAME], 0)
PARAMS = params_from_jax({k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else np.asarray(v))
                          for k, v in JPARAMS.items()}, device="cpu")
ENGINE = dict(num_pages=64, page_size=PAGE, max_batch_size=4, max_prefill_tokens=32, max_seq_len=128,
              chunk_prefill_tokens=8)


class _FakeTime:
    """The core module's ``time`` under test: monotonic and perf_counter read
    the fake clock, so arrival, admission, first-token and step wall times
    are the same in both engines."""

    def __init__(self, clk):
        self._clk = clk

    def monotonic(self):
        return self._clk.t

    perf_counter = monotonic

    def time(self):
        return time.time()


def _advance_on_dispatch(runner, clk):
    """A dispatch of B rows x T tokens takes 2 ms a row and 0.5 ms a token on
    the fake clock: the engines' step walls, and so the chunk controller's
    decisions, follow the compositions."""
    for name in ("step", "step_async"):
        inner = getattr(runner, name, None)
        if inner is None:
            continue

        def timed(batch, *a, _inner=inner, **k):
            b, t = np.asarray(batch.tokens).shape
            clk.t += (2.0 * b + 0.5 * t) / 1e3
            return _inner(batch, *a, **k)

        setattr(runner, name, timed)


def _runners(num_pages):
    jrunner = ModelRunner(JPRESETS[NAME], JPARAMS, num_pages=num_pages, page_size=PAGE,
                          max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, attn_impl="reference")
    trunner = TorchModelRunner(PRESETS[NAME], PARAMS, num_pages=num_pages, page_size=PAGE,
                               max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, device="cpu")
    return jrunner, trunner


def _drive(P, core, clk, arrivals, *, step_dt=1e-3, max_steps=400):
    """Requests (step, prompt, max_tokens, tenant, priority) join at their
    step index, arriving on the fake clock; returns the admission order, the
    per-step admission records and each request's tokens."""
    admitted = []
    on_admit = core.admission.on_admit

    def record(seq, now=None):
        on_admit(seq, now)
        admitted.append((seq.seq_id, round(now, 9), core.admission._charges.get(seq.seq_id)))

    core.admission.on_admit = record
    tokens, steps = {}, []
    for step in range(max_steps):
        clk.t += step_dt
        for at, prompt, n, tenant, prio in arrivals:
            if at == step:
                seq = core.add_request(_req(P, prompt, tenant=tenant, priority=prio, max_tokens=n))
                seq.arrival_time = clk.t
        if step > max(a[0] for a in arrivals) and not core.has_work:
            break
        for seq, out in core.step():
            tokens.setdefault(seq.seq_id, []).extend(out.token_ids)
        steps.append(dict(core.last_admission))
    return admitted, steps, tokens


def _slo_run(P, core_cls, cfg_cls, runner, core_mod, monkeypatch, arrivals, *, quotas, engine_kw=None,
             block_manager=None):
    clk = _Clock(1.0)
    monkeypatch.setattr(core_mod, "time", _FakeTime(clk))
    _advance_on_dispatch(runner, clk)
    ctl = _ctl(P, clk, budget=0.05, quotas=quotas, prefill_tokens_per_sec=4000.0)
    chunk = P.sched.ChunkBudgetController(ENGINE["chunk_prefill_tokens"], itl_budget_ms=10.0, floor_tokens=2,
                                          cooldown_steps=2, window=8, min_samples=2)
    kw = {**ENGINE, "num_pages": runner.num_pages, "slo_sched": True, **(engine_kw or {})}
    core = core_cls(runner, cfg_cls(**kw), admission=ctl, chunk_controller=chunk, block_manager=block_manager)
    admitted, steps, tokens = _drive(P, core, clk, arrivals)
    budgets = [r.get("chunk_tokens") for r in core.flight.snapshot(kind="step")] if hasattr(core, "flight") else []
    return dict(admitted=admitted, steps=steps, tokens=tokens, budgets=budgets,
                counters=[dict(ctl.tenants.throttled), ctl.throttle_events, ctl.admitted_total, ctl.deadline_misses,
                          ctl.predictor.bias, ctl.predictor.observations, ctl.last_slack_ms, chunk.shrinks,
                          chunk.relaxes, chunk.current, dict(ctl._charges), ctl.tenants.inflight("heavy"),
                          core.num_preemptions, core.mixed_steps])


HEAVY = {"heavy": dict(rate_tokens_per_s=2000.0, burst_tokens=48.0, max_inflight_tokens=64)}
SLO_ARRIVALS = ([(0, list(range(3 + i, 27 + i)), 6, "heavy", 2) for i in range(4)]
                + [(3, [40 + i, 41, 42, 43, 44, 45], 6, "light", 0) for i in range(3)]
                + [(5, list(range(60, 75)), 5, None, 1)])


def test_slo_engine_equals_jax(monkeypatch):
    """Both cores under the SLO plane on the same arrivals (a heavy tenant at
    priority 2 over its bucket and in-flight cap, a light one at 0 and a
    default request at 1): the admission order and times, last_admission a
    step, the throttle, deferral and deadline-miss counts, the predictor's
    bias, the chunk controller's moves and every greedy token, bitwise."""
    jrunner, trunner = _runners(ENGINE["num_pages"])
    want = _slo_run(JAX, JEngineCore, JEngineConfig, jrunner, jcore_mod, monkeypatch, SLO_ARRIVALS, quotas=HEAVY)
    got = _slo_run(TORCH, EngineCore, EngineConfig, trunner, tcore_mod, monkeypatch, SLO_ARRIVALS, quotas=HEAVY)
    for key in ("admitted", "steps", "tokens", "counters", "budgets"):
        assert got[key] == want[key], key
    order = [sid for sid, _, _ in got["admitted"]]
    assert sorted(order) == list(range(8)) and order.index(4) < order.index(3)  # a light one overtakes a heavy one
    assert got["counters"][0]["heavy"] > 0 and "light" not in got["counters"][0]
    assert sum(r["deferred"] > 0 for r in got["steps"]) > 0 and got["counters"][7] > 0  # the chunk budget shrank
    assert all(len(got["tokens"][i]) == n for i, (_, _, n, _, _) in enumerate(SLO_ARRIVALS))


def test_cache_aware_engine_with_g2_equals_jax(monkeypatch, tmp_path):
    """slo_sched + cache_aware with a G2 tier: a prompt evicted from the
    card's pages into G2 comes back beside two cold ones; its admission
    prices and charges only its residual tokens (cached_frac > 0), and
    every record, count and greedy token equals the JAX engine's."""
    pa = list(range(1, 13))
    arrivals = [(0, pa, 3, "t", 0), (8, [50 + i for i in range(12)], 3, "t", 0),
                (16, [80 + i for i in range(12)], 3, "t", 0),
                (24, pa, 3, "t", 0), (24, [100 + i for i in range(8)], 3, "t", 0),
                (24, [120 + i for i in range(8)], 3, "t", 0)]
    quotas = {"t": dict(max_inflight_tokens=16)}
    bm_kw = dict(g2_capacity_blocks=16)
    jrunner, trunner = _runners(7)
    jbm = jblocks.KvBlockManager(jblocks.BlockManagerConfig(g3_path=tmp_path / "j", **bm_kw),
                                 read_page=jrunner.read_page, write_page=jrunner.write_page,
                                 write_pages=jrunner.write_pages)
    tbm = tblocks.KvBlockManager(tblocks.BlockManagerConfig(g3_path=tmp_path / "t", **bm_kw),
                                 read_page=trunner.read_page, write_page=trunner.write_page,
                                 write_pages=trunner.write_pages)
    engine_kw = dict(cache_aware=True, max_prefill_tokens=256)
    want = _slo_run(JAX, JEngineCore, JEngineConfig, jrunner, jcore_mod, monkeypatch, arrivals, quotas=quotas,
                    engine_kw=engine_kw, block_manager=jbm)
    got = _slo_run(TORCH, EngineCore, EngineConfig, trunner, tcore_mod, monkeypatch, arrivals, quotas=quotas,
                   engine_kw=engine_kw, block_manager=tbm)
    for key in ("admitted", "steps", "tokens", "counters", "budgets"):
        assert got[key] == want[key], key
    assert got["tokens"][3] == got["tokens"][0]  # the repeat's tokens are the first serve's
    charged = {sid: charge for sid, _, charge in got["admitted"]}
    assert charged[0] == ("t", 12) and charged[4] == ("t", 8) and charged[3][1] < 12  # the repeat: its residual
    assert (tbm.offloaded, tbm.onboarded) == (jbm.offloaded, jbm.onboarded) and tbm.onboarded >= 2
    warm = [r for r in got["steps"] if r["cached_frac"] > 0]
    assert warm and all(0 < r["cached_frac"] < 1 for r in warm)


def test_slo_sched_off_is_fifo():
    """With the plane off no controller exists, the queue keeps arrival
    order (an urgent request does not overtake), the chunk budget is the
    config's, and the STEP records carry the admission fields at zero
    slack."""
    core = EngineCore(_runners(ENGINE["num_pages"])[1], EngineConfig(**ENGINE))
    assert core.admission is None and core.chunk_controller is None and core.chunk_budget_tokens() == 8
    seqs = [core.add_request(_req(TORCH, range(1, 30), priority=3, tenant="heavy")),
            core.add_request(_req(TORCH, range(1, 6), priority=0))]
    first = {}
    for step in range(100):
        if not core.has_work:
            break
        for seq, out in core.step():
            first.setdefault(seq.seq_id, step)
    assert first[seqs[0].seq_id] <= first[seqs[1].seq_id]
    steps = core.flight.snapshot(kind="step")
    assert steps and all(r["deadline_slack_ms"] == 0.0 and r["deferred"] == 0 for r in steps)
    assert sum(r["admitted"] for r in steps) == 2


def test_overlap_reads_admission_at_effective_state(monkeypatch):
    """The overlapped engine composes each step before the previous one's
    tokens land. Under the SLO plane it releases the quota charges of rows
    that finish inside the step in flight before it gates the queue, as the
    synchronous engine has by then: every request is admitted at the same
    dispatch index, with the same tokens, as in the synchronous engine."""
    arrivals = [(0, list(range(3 + i, 19 + i)), 3 + i, "heavy", 1) for i in range(4)] + \
               [(1, [60 + i, 61, 62], 4, None, 0) for i in range(2)]

    def run(overlap):
        clk = _Clock(1.0)  # frozen: ordering and quotas only, no refill, no bias update
        monkeypatch.setattr(tcore_mod, "time", _FakeTime(clk))
        runner = _runners(ENGINE["num_pages"])[1]
        dispatches = [0]
        for name in ("step", "step_async"):
            inner = getattr(runner, name)

            def counted(*a, _inner=inner, **k):
                dispatches[0] += 1
                return _inner(*a, **k)

            setattr(runner, name, counted)
        ctl = _ctl(TORCH, clk, quotas={"heavy": dict(max_inflight_tokens=40)})
        core = EngineCore(runner, EngineConfig(**ENGINE, slo_sched=True, overlap=overlap), admission=ctl,
                          chunk_controller=TORCH.sched.ChunkBudgetController(8, itl_budget_ms=1e9))
        on_admit, order = ctl.on_admit, []
        ctl.on_admit = lambda seq, now=None: (order.append((seq.seq_id, dispatches[0])), on_admit(seq, now))
        _, _, tokens = _drive(TORCH, core, clk, arrivals, step_dt=0.0)
        return order, tokens, dict(ctl.tenants.throttled), core

    order, tokens, throttled, sync = run(False)
    o_order, o_tokens, o_throttled, over = run(True)
    assert o_order == order and o_tokens == tokens and o_throttled == throttled and throttled["heavy"] > 0
    assert over.overlap_step_counts["overlapped"] > 0 and not over.admission._charges


def test_chunk_controller_sees_step_walls_less_captures(monkeypatch):
    """A step that captures a graph key spends the capture inside its wall:
    the STEP record keeps the raw wall, and the chunk-budget controller is
    fed the wall less the capture, so one-off captures do not shrink the
    budget."""
    clk = _Clock(1.0)
    monkeypatch.setattr(tcore_mod, "time", _FakeTime(clk))
    runner = _runners(ENGINE["num_pages"])[1]
    calls = [0]
    for name in ("step", "step_async"):
        inner = getattr(runner, name)

        def timed(*a, _inner=inner, **k):
            calls[0] += 1
            clk.t += 2e-3
            if calls[0] % 3 == 0:  # a first capture of a key, 0.5 s
                clk.t += 0.5
                runner.capture_seconds += 0.5
            return _inner(*a, **k)

        setattr(runner, name, timed)
    chunk = TORCH.sched.ChunkBudgetController(8, itl_budget_ms=10.0, floor_tokens=2, cooldown_steps=2, window=8,
                                              min_samples=2)
    seen, observe = [], chunk.observe
    chunk.observe = lambda ms: (seen.append(ms), observe(ms))
    core = EngineCore(runner, EngineConfig(**ENGINE, slo_sched=True), admission=_ctl(TORCH, clk),
                      chunk_controller=chunk)
    _drive(TORCH, core, clk, [(0, list(range(1, 30)), 8, None, 0), (1, list(range(30, 50)), 8, None, 0)],
           step_dt=0.0)
    walls = [r["wall_ms"] for r in core.flight.snapshot(kind="step") if r["decode_rows"]]
    assert len(seen) == len(walls) >= 8 and max(walls) > 500
    assert max(seen) < 5 and chunk.shrinks == 0 and chunk.budget() == 8


def test_flags_reach_the_engine_and_the_router(monkeypatch):
    """EngineConfig takes slo_sched and cache_aware (swa_free_pages stays
    refused); DYN_SLO_SCHED and DYN_CACHE_AWARE reach the launcher's engine
    fields and arm build_kv_router's cost terms."""
    with pytest.raises(TypeError, match="swa_free_pages"):
        EngineConfig(swa_free_pages=True)
    core = EngineCore(_runners(ENGINE["num_pages"])[1], EngineConfig(**ENGINE, slo_sched=True, cache_aware=True))
    assert core.admission is not None and core.admission.cached_tokens_fn is not None
    assert core.chunk_controller is not None and core.chunk_controller.base == 8
    monkeypatch.setenv("DYN_SLO_SCHED", "1")
    monkeypatch.setenv("DYN_CACHE_AWARE", "1")
    env = launch._engine_env()
    assert env["slo_sched"] and env["cache_aware"] and env["async_onboard"]

    async def router_config():
        from dynamo_tpu_torch.router.router import build_kv_router
        from dynamo_tpu_torch.runtime.component import DistributedRuntime

        runtime = DistributedRuntime.detached()
        try:
            engine, subscriber, aggregator = await build_kv_router(runtime, namespace="ns", component="c",
                                                                   block_size=32)
            await subscriber.close()
            await aggregator.close()
            return engine.router.scheduler.config
        finally:
            await runtime.close()

    cfg = asyncio.run(router_config())
    assert (cfg.attainment_weight, cfg.ttft_slo_s, cfg.cache_aware_weight, cfg.cache_block_tokens) == (1.0, 0.5,
                                                                                                        1.0, 32)
