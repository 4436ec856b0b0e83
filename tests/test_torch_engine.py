"""dynamo_tpu_torch engine and pipeline held against dynamo_tpu (JAX) on the CPU.

Both engines serve test-tiny with the same parameters (carried over by
bridge.params_from_jax); greedy tokens must be bitwise equal, with chunked
prefill forced by a small chunk budget so mixed prefill+decode steps occur.
"""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.backend import Backend as JBackend
from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.engine.service import JaxEngineService
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.preprocessor import OpenAIPreprocessor as JPreprocessor
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.launch import build_engine_service, build_pipeline
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.runtime.engine import Context

NAME = "test-tiny"
PAGE = 4
ENGINE = dict(num_pages=48, page_size=PAGE, max_batch_size=4, max_prefill_tokens=64,
              max_seq_len=128, chunk_prefill_tokens=8, eos_token_ids=(257,))
JPARAMS = jllama.init_params(JPRESETS[NAME], 0)
PARAMS = params_from_jax({k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                              else np.asarray(v)) for k, v in JPARAMS.items()}, device="cpu")


def _jax_core(**engine_kw):
    runner = ModelRunner(JPRESETS[NAME], JPARAMS, num_pages={**ENGINE, **engine_kw}["num_pages"], page_size=PAGE,
                         max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, attn_impl="reference")
    return JEngineCore(runner, JEngineConfig(**{**ENGINE, **engine_kw}))


def _torch_core(**engine_kw):
    runner = TorchModelRunner(PRESETS[NAME], PARAMS, num_pages={**ENGINE, **engine_kw}["num_pages"], page_size=PAGE,
                              max_batch_size=ENGINE["max_batch_size"], prefill_bucket=16, device="cpu")
    return EngineCore(runner, EngineConfig(**{**ENGINE, **engine_kw}))


def _drive(core, make_request, arrivals):
    """Requests join at their step index; returns tokens per request index."""
    outputs, seq_of, events = {}, {}, 0
    for step in range(400):
        for i, (at, prompt, n) in enumerate(arrivals):
            if at == step:
                seq_of[core.add_request(make_request(prompt, n)).seq_id] = i
        if step > max(a for a, _, _ in arrivals) and not core.has_work:
            break
        for seq, out in core.step():
            outputs.setdefault(seq_of[seq.seq_id], []).extend(out.token_ids)
        events += 1
    return outputs


@pytest.mark.parametrize("chunk", [8, 0])  # mixed steps; whole-prompt prefill-XOR-decode steps
def test_engine_core_greedy_tokens_equal_jax(chunk):
    # Request 2 shares request 0's first 16 tokens: a prefix-cache hit.
    arrivals = [(0, list(range(3, 23)), 7), (2, [9, 8, 7, 6, 5], 9), (3, list(range(3, 19)) + list(range(40, 55)), 5)]

    def jreq(prompt, n):
        return JRequest(token_ids=prompt, sampling=JSampling(temperature=0.0), stop=JStop(max_tokens=n))

    def treq(prompt, n):
        return PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                   stop=StopConditions(max_tokens=n))

    jcore, tcore = _jax_core(chunk_prefill_tokens=chunk), _torch_core(chunk_prefill_tokens=chunk)
    want = _drive(jcore, jreq, arrivals)
    got = _drive(tcore, treq, arrivals)
    assert got == want
    assert [len(got[i]) for i in range(3)] == [7, 9, 5]
    assert tcore.mixed_steps == jcore.mixed_steps and (tcore.mixed_steps > 0) == (chunk > 0)
    assert tcore.stall_violations == jcore.stall_violations and (tcore.stall_violations == 0) == (chunk > 0)
    tm, jm = tcore.metrics(), jcore.metrics()
    for field in ("prompt_tokens_total", "generated_tokens_total", "kv_active_blocks", "cache_hit_rate"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert tm.cache_hit_rate > 0


def test_engine_core_seeded_sampled_tokens_equal_jax():
    """Seeded temperature > 0 requests (with top-k and top-p), mixed steps
    and a prefix-cache hit: tokens bitwise equal to the JAX engine's. Both
    draw jax.random.categorical's threefry Gumbel noise from
    fold_in(PRNGKey(seed), sample_steps) (the port computes it in torch);
    the noise agrees to an ulp of the logs, and the tokens exactly."""
    arrivals = [(0, list(range(3, 23)), 12), (1, [9, 8, 7, 6, 5], 14), (2, list(range(3, 19)) + list(range(30, 44)), 9)]
    sampling = [dict(temperature=0.9, top_p=0.95, seed=1234), dict(temperature=1.3, top_k=40, seed=2**31 + 5),
                dict(temperature=0.7, seed=0)]

    def reqs(req, samp, stop):
        made = []

        def make(prompt, n):
            made.append(req(token_ids=prompt, sampling=samp(**sampling[len(made)]), stop=stop(max_tokens=n)))
            return made[-1]
        return make

    want = _drive(_jax_core(), reqs(JRequest, JSampling, JStop), arrivals)
    got = _drive(_torch_core(), reqs(PreprocessedRequest, SamplingOptions, StopConditions), arrivals)
    assert got == want
    assert [len(got[i]) for i in range(3)] == [12, 14, 9]
    greedy = _drive(_torch_core(), reqs(PreprocessedRequest, lambda **kw: SamplingOptions(temperature=0.0),
                                        StopConditions), arrivals)
    assert greedy != got  # the draws did sample


def test_preemption_counts_and_greedy_tokens_equal_jax():
    """Four requests (prompts of 15-20 tokens, 25-30 new tokens each) on 24
    pages of 4 tokens, 8-token chunks: both engines run out of pages and
    preempt, equally often, every request still runs to its length, and the
    greedy tokens are equal."""
    arrivals = [(0, list(range(3, 18)), 25), (0, list(range(20, 38)), 28), (1, list(range(40, 60)), 30),
                (2, list(range(60, 76)), 26)]
    jcore, tcore = _jax_core(num_pages=24), _torch_core(num_pages=24)

    def jreq(prompt, n):
        return JRequest(token_ids=prompt, sampling=JSampling(temperature=0.0), stop=JStop(max_tokens=n))

    def treq(prompt, n):
        return PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                   stop=StopConditions(max_tokens=n))

    want = _drive(jcore, jreq, arrivals)
    got = _drive(tcore, treq, arrivals)
    assert got == want
    assert [len(got[i]) for i in range(4)] == [25, 28, 30, 26]
    assert tcore.num_preemptions == jcore.num_preemptions > 0


def test_pipeline_text_equals_jax():
    body = {"model": NAME, "prompt": "the port serves what the reference serves", "max_tokens": 12,
            "temperature": 0.0, "stop": ["\x00\x00\x00\x00"]}

    async def run_jax():
        svc = JaxEngineService(_jax_core())
        pipe = JPreprocessor(JBackend(svc, JByteTokenizer()), JByteTokenizer(), default_max_tokens=64)
        try:
            return "".join([o.text async for o in pipe.generate(dict(body), JContext())])
        finally:
            await svc.close()

    async def run_torch():
        svc = await build_engine_service(NAME, device="cpu", params=PARAMS, **ENGINE)
        pipe = build_pipeline(svc)
        try:
            outs = [o async for o in pipe.generate(dict(body), Context())]
            assert outs[-1].finish_reason is not None
            return "".join(o.text for o in outs)
        finally:
            await svc.close()

    want = asyncio.run(run_jax())
    got = asyncio.run(run_torch())
    assert got == want and got


@pytest.mark.parametrize("flag", [dict(slo_sched=True), dict(cache_aware=True), dict(swa_free_pages=True)])
def test_unported_engine_flags_are_refused(flag):
    """``swa_free_pages`` waits for the sliding window: no such field, so the
    error names it. The SLO plane's flags, once refused the same way, are
    fields now (tests/test_torch_sched.py serves them)."""
    name = next(iter(flag))
    if name == "swa_free_pages":
        with pytest.raises(TypeError, match=name):
            EngineConfig(**{**ENGINE, **flag})
    else:
        assert getattr(EngineConfig(**{**ENGINE, **flag}), name) is True
