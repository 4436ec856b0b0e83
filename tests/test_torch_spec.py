"""The port's speculative decoding and decode bursts on the CPU (the port's
counterpart of ``tests/test_spec_decode.py``).

The contract: with ``spec_k > 0`` the engine emits bit-identical tokens (and
logprobs) to ``spec_k = 0``, greedy and seeded, with chunked prefill mixing
into the same steps, because the verify dispatch samples each column as the
non-speculative step would after j accepted tokens (fold counter
``sample_steps + j``) and only the matching prefix is accepted. The same
holds for ``decode_steps > 1`` bursts, for the overlapped engine
(``overlap_spec``), for fp8 caches, and against the JAX engine's own spec
and burst runs on the same parameters (``bridge.params_from_jax``). Also: the
n-gram proposer against JAX's, page rollback, the draft cap at the context
window, the rng fold discipline, the launcher's flags, and the decode
kernel's plain version past 32 query tokens against JAX's reference.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.engine.spec import NgramProposer as JNgramProposer
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.ops.attention import paged_attention_reference as jax_reference
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner
from dynamo_tpu_torch.engine.spec import NgramProposer, build_proposer
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.ops import paged_decode
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

PAGE = 4
_JPARAMS: dict = {}
_RUNNERS: dict = {}


def jparams_for(preset):
    if preset not in _JPARAMS:
        _JPARAMS[preset] = jllama.init_params(JPRESETS[preset], 0)
    return _JPARAMS[preset]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def make_core(preset="test-tiny", *, spec_k=0, chunk=16, num_pages=96, max_seq_len=256, cache_dtype=None,
              params=None, **cfg_kw):
    """An engine over one runner per (preset, cache type), shared by every
    core of the file (a fresh EngineCore owns the page pool anew; prefill
    rewrites recycled pages before anything attends to them)."""
    key = (preset, cache_dtype, params is not None)
    if key not in _RUNNERS or params is not None:
        p = params if params is not None else params_from_jax(_numpy_tree(jparams_for(preset)), device="cpu")
        _RUNNERS[key] = TorchModelRunner(PRESETS[preset], p, num_pages=num_pages, page_size=PAGE, max_batch_size=8,
                                         prefill_bucket=16, cache_dtype=cache_dtype, device="cpu")
    return EngineCore(_RUNNERS[key], EngineConfig(
        num_pages=num_pages, page_size=PAGE, max_batch_size=8, max_seq_len=max_seq_len,
        chunk_prefill_tokens=chunk, spec_k=spec_k, **cfg_kw))


def jax_core(preset="test-tiny", *, spec_k=0, chunk=16, **cfg_kw):
    runner = ModelRunner(JPRESETS[preset], jparams_for(preset), num_pages=96, page_size=PAGE, max_batch_size=8,
                         prefill_bucket=16, attn_impl="reference")
    return JEngineCore(runner, JEngineConfig(num_pages=96, page_size=PAGE, max_batch_size=8, max_seq_len=256,
                                             chunk_prefill_tokens=chunk, spec_k=spec_k, **cfg_kw))


def run_all(core, reqs, max_steps=300):
    """Drive to completion; returns ({seq_id: tokens}, {seq_id: logprobs})."""
    tokens, lps = {}, {}
    for req in reqs:
        seq = core.add_request(req)
        tokens[seq.seq_id] = []
        lps[seq.seq_id] = []
    steps = 0
    while core.has_work and steps < max_steps:
        for seq, out in core.step():
            tokens[seq.seq_id].extend(out.token_ids)
            if out.logprobs:
                lps[seq.seq_id].extend(out.logprobs)
        steps += 1
    assert not core.has_work, "engine did not drain"
    return tokens, lps


def _requests(vocab, req=PreprocessedRequest, samp=SamplingOptions, stop=StopConditions):
    """tests/test_spec_decode.py's mix: a periodic prompt the drafter matches,
    a long prompt whose chunked prefill rides the verify steps (seeded, with
    logprobs), and a seeded short one."""
    return [
        req(token_ids=[5, 7, 5, 7, 5, 7, 9, 11], sampling=samp(temperature=0.0),
            stop=stop(max_tokens=20, ignore_eos=True)),
        req(token_ids=[i % (vocab - 2) + 1 for i in range(40)],
            sampling=samp(temperature=0.8, seed=42, logprobs=3), stop=stop(max_tokens=12, ignore_eos=True)),
        req(token_ids=[3, 3, 3, 3, 2, 1], sampling=samp(temperature=0.7, seed=7),
            stop=stop(max_tokens=12, ignore_eos=True)),
    ]


def _zero_params(preset="test-tiny"):
    """Zeroed weights: every logit ties, greedy argmax is always token 0, so
    the stream is [0, 0, ...] and every draft is accepted."""
    return {k: _zero_params_tree(v) for k, v in params_from_jax(_numpy_tree(jparams_for(preset)),
                                                                 device="cpu").items()}


def _zero_params_tree(v):
    return {k: _zero_params_tree(x) for k, x in v.items()} if isinstance(v, dict) else torch.zeros_like(v)


# -- proposer -----------------------------------------------------------------


def test_ngram_proposer_equals_jax_on_seeded_histories():
    """The port's vectorized scan proposes the JAX scan's drafts."""
    rng = np.random.default_rng(0)
    pairs = [(NgramProposer(*g), JNgramProposer(*g)) for g in ((3, 1), (4, 2), (1, 1))]
    for _ in range(1000):
        n = int(rng.integers(0, 60))
        hist = rng.integers(0, int(rng.integers(1, 6)), n).tolist()  # small alphabets repeat
        k = int(rng.integers(0, 7))
        for port, ref in pairs:
            assert port.propose(hist, k) == ref.propose(hist, k), (hist, k)
    assert NgramProposer(max_ngram=2).propose([1, 2, 3, 1, 2], 2) == JNgramProposer(max_ngram=2).propose(
        [1, 2, 3, 1, 2], 2) == [3, 1]
    assert isinstance(build_proposer(), NgramProposer)
    with pytest.raises(ValueError):
        build_proposer("draft-model-7b")
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)


# -- losslessness ------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_decode_is_lossless(preset, spec_k):
    """Tokens and logprobs bitwise equal to spec_k=0, greedy and seeded, with
    chunked prefill in the verify steps."""
    vocab = PRESETS[preset].vocab_size
    base_tok, base_lp = run_all(make_core(preset), _requests(vocab))
    core = make_core(preset, spec_k=spec_k)
    spec_tok, spec_lp = run_all(core, _requests(vocab))
    assert spec_tok == base_tok
    assert spec_lp == base_lp
    assert core.spec_tokens_proposed > 0 and core.spec_steps > 0


def test_spec_tokens_equal_the_jax_engines_spec_run():
    """The port's spec engine against the JAX engine's spec run (test-tiny,
    spec_k 3, same parameters): greedy and seeded tokens equal, and the
    same drafts proposed."""
    vocab = PRESETS["test-tiny"].vocab_size
    jcore = jax_core(spec_k=3)
    want, _ = run_all(jcore, _requests(vocab, JRequest, JSampling, JStop))
    core = make_core(spec_k=3)
    got, _ = run_all(core, _requests(vocab))
    assert got == want
    assert core.spec_tokens_proposed == jcore.spec_tokens_proposed


@pytest.mark.parametrize("overlap", [False, True])
def test_spec_decode_lossless_without_chunking(overlap):
    """chunk_prefill_tokens=0 (phase-exclusive prefill) still speculates on
    pure-decode steps, synchronous and overlapped."""
    vocab = PRESETS["test-tiny"].vocab_size
    base_tok, base_lp = run_all(make_core(chunk=0), _requests(vocab))
    core = make_core(chunk=0, spec_k=3, overlap=overlap)
    spec_tok, spec_lp = run_all(core, _requests(vocab))
    assert (spec_tok, spec_lp) == (base_tok, base_lp)
    assert core.spec_tokens_proposed > 0


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
def test_spec_lossless_on_fp8_kv_cache(preset):
    """The same fp8 cache with and without speculation: bitwise equal."""
    fp8 = torch.float8_e4m3fn
    vocab = PRESETS[preset].vocab_size
    base_core = make_core(preset, cache_dtype=fp8)
    assert base_core.runner.k_cache.dtype == fp8
    base_tok, base_lp = run_all(base_core, _requests(vocab))
    core = make_core(preset, spec_k=3, cache_dtype=fp8, overlap=True)
    assert run_all(core, _requests(vocab)) == (base_tok, base_lp)
    assert core.spec_tokens_proposed > 0


def _dispatches(core):
    """Record every runner dispatch's composition: (kind, tokens fed from the
    host past column 0, positions, padded-to shapes)."""
    log = []
    r = core.runner

    def rec(kind, sb):
        log.append((kind, sb.tokens[:, 1:].tolist(), sb.positions.tolist(), sb.block_tables.shape,
                    None if sb.spec_start is None else sb.spec_start.tolist()))

    for name, kind in (("step", "step"), ("step_async", "step"), ("spec_step", "spec"),
                       ("spec_step_async", "spec"), ("multi_step", "burst")):
        fn = getattr(r, name)
        setattr(r, name, lambda sb, *a, _fn=fn, _k=kind, **kw: (rec(_k, sb), _fn(sb, *a, **kw))[1])
    return log


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
def test_overlap_spec_matches_sync_and_dispatches_its_compositions(preset):
    """overlap_spec: tokens and logprobs bitwise the synchronous spec
    engine's, and every dispatch carries the same rows, drafts, positions and
    tables (a verify's acceptance decides the next step, so each step in
    flight is harvested before the next is scheduled: barrier "spec")."""
    vocab = PRESETS[preset].vocab_size
    params = params_from_jax(_numpy_tree(jparams_for(preset)), device="cpu")
    sync = make_core(preset, spec_k=3, params=params)  # a runner of its own: its dispatches are spied on
    sync_log = _dispatches(sync)
    want = run_all(sync, _requests(vocab))
    over = make_core(preset, spec_k=3, overlap=True, params=params)
    over_log = _dispatches(over)
    assert run_all(over, _requests(vocab)) == want
    assert over_log == sync_log
    assert over.overlap_barrier_counts.get("spec", 0) > 0
    assert over.spec_tokens_accepted == sync.spec_tokens_accepted > 0
    # overlap_spec off barriers every spec step to the synchronous verify.
    off = make_core(preset, spec_k=3, overlap=True, overlap_spec=False)
    assert run_all(off, _requests(vocab)) == want
    assert off._inflight is None and off.overlap_step_counts["overlapped"] == 0


@pytest.mark.parametrize("overlap", [False, True])
def test_decode_steps_burst_is_lossless_and_equals_jax(overlap):
    """decode_steps=4: tokens and logprobs bitwise decode_steps=1's (the
    synchronous burst is one fused multi_step dispatch; the overlapped one
    chains sub-steps behind the primary), and tokens equal the JAX engine's
    decode_steps=4 run."""
    vocab = PRESETS["test-tiny"].vocab_size
    reqs = lambda: [r for r in _requests(vocab) if not r.sampling.logprobs] + [PreprocessedRequest(
        token_ids=[9, 8, 7], sampling=SamplingOptions(temperature=0.9, seed=3),
        stop=StopConditions(max_tokens=15, ignore_eos=True))]
    base = run_all(make_core(chunk=0), reqs())
    core = make_core(chunk=0, decode_steps=4, overlap=overlap,
                     params=params_from_jax(_numpy_tree(jparams_for("test-tiny")), device="cpu"))
    log = _dispatches(core)
    assert run_all(core, reqs()) == base
    if overlap:
        assert core.overlap_step_counts["overlapped"] > 0
    else:
        assert any(kind == "burst" for kind, *_ in log)
    if not overlap:  # the JAX engine's run, once
        jreqs = [JRequest(token_ids=r.token_ids, sampling=JSampling(temperature=r.sampling.temperature,
                                                                    seed=r.sampling.seed),
                          stop=JStop(max_tokens=r.stop.max_tokens, ignore_eos=True)) for r in reqs()]
        want, _ = run_all(jax_core(chunk=0, decode_steps=4), jreqs)
        assert base[0] == want


def test_multi_step_equals_single_steps_with_penalties():
    """Runner level: a 4-step burst of penalized, seeded rows equals four
    single steps fed their own samples (the burst writes its samples into
    the penalty history in-graph), slots taken from the tables."""
    cfg = PRESETS["test-tiny"]
    params = params_from_jax(_numpy_tree(jparams_for("test-tiny")), device="cpu")
    runners = [TorchModelRunner(cfg, params, num_pages=32, page_size=PAGE, max_batch_size=4, device="cpu")
               for _ in range(2)]
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3]]
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)

    def batch(tokens, starts, steps, history):
        b, t = len(tokens), max(len(x) for x in tokens)
        tok, pos = np.zeros((b, t), np.int32), np.zeros((b, t), np.int32)
        for i, (x, s) in enumerate(zip(tokens, starts)):
            tok[i, :len(x)], pos[i, :len(x)] = x, np.arange(s, s + len(x))
        slots = (tables[np.arange(b)[:, None], pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
        return StepBatch(tok, pos, tables, slots, np.array([len(x) - 1 for x in tokens], np.int32),
                         np.array([0.8, 0.0], np.float32), np.zeros(b, np.int32), np.ones(b, np.float32),
                         np.array([11, 12], np.uint32), np.array(steps, np.int32), np.full(b, 0.5, np.float32),
                         np.full(b, 0.3, np.float32), np.full(b, 20, np.int32), history)

    hist = np.full((2, 8), -1, np.int32)
    first = runners[0].step(batch(prompts, [0, 0], [0, 0], hist))
    runners[1].step(batch(prompts, [0, 0], [0, 0], hist))
    hist[:, 0] = first
    burst = runners[0].multi_step(batch([[int(t)] for t in first], [5, 3], [1, 1], hist.copy()), 4)
    toks, singles = first, []
    for j in range(4):
        toks = runners[1].step(batch([[int(t)] for t in toks], [5 + j, 3 + j], [1 + j] * 2, hist.copy()))
        hist[:, 1 + j] = toks
        singles.append(toks)
    assert burst.shape == (2, 4)
    assert np.array_equal(burst, np.stack(singles, 1))


def test_spec_step_columns_equal_sequential_steps():
    """Runner level: column j of a verify (drafts = the true continuation)
    equals the token a plain step samples after j accepted tokens, seeded
    (fold counter sample_steps + j), with per-column top-3 ids equal and
    logprobs within 1e-5."""
    cfg = PRESETS["test-tiny"]
    params = params_from_jax(_numpy_tree(jparams_for("test-tiny")), device="cpu")
    spec_r, step_r = (TorchModelRunner(cfg, params, num_pages=32, page_size=PAGE, max_batch_size=4, device="cpu")
                      for _ in range(2))
    prompt, tables = [3, 1, 4, 1, 5, 9], np.array([[1, 2, 3, 4, 5, 6]], np.int32)

    def batch(tokens, start, step):
        pos = np.arange(start, start + len(tokens), dtype=np.int32)[None]
        slots = (tables[0, pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
        return StepBatch(np.array([tokens], np.int32), pos, tables, slots, np.array([len(tokens) - 1], np.int32),
                         np.array([0.9], np.float32), np.zeros(1, np.int32), np.ones(1, np.float32),
                         np.array([77], np.uint32), np.array([step], np.int32), np.zeros(1, np.float32),
                         np.zeros(1, np.float32), np.full(1, 24, np.int32), np.full((1, 1), -1, np.int32))

    t0 = int(step_r.step(batch(prompt, 0, 0))[0])
    spec_r.step(batch(prompt, 0, 0))
    seq, lps = [t0], []
    for j in range(3):
        tok, aux = step_r.step(batch([seq[-1]], len(prompt) + j, 1 + j), lp_k=3)
        seq.append(int(tok[0]))
        lps.append(aux)
    sb = batch(seq[:4], len(prompt), 1)
    sb.spec_start = np.zeros(1, np.int32)
    targets, aux = spec_r.spec_step(sb, 4, lp_k=3)
    assert targets[0, :3].tolist() == seq[1:4]
    for j in range(3):
        # A 4-token row and a 1-token row reach the CPU's matmuls in other
        # shapes, whose row blocking may round the last bit differently.
        np.testing.assert_allclose(aux["logprob"][0, j], lps[j]["logprob"][0], rtol=1e-5)
        assert np.array_equal(aux["top_ids"][0, j], lps[j]["top_ids"][0])


# -- acceptance, pages and the rng fold -----------------------------------------


def test_acceptance_on_a_repetitive_stream_and_pages_released():
    core = make_core(spec_k=4, params=_zero_params())
    req = PreprocessedRequest(token_ids=[1, 2, 3, 4], sampling=SamplingOptions(temperature=0.0),
                              stop=StopConditions(max_tokens=24, ignore_eos=True))
    toks, _ = run_all(core, [req])
    assert toks[0] == [0] * 24
    assert core.spec_tokens_accepted == core.spec_tokens_proposed > 0
    assert core.last_step_info["spec_drafted"] >= 0 and core.spec_steps > 0
    assert core.allocator.stats().active_pages == 0
    # Rejected-draft rollback and teardown over the mixed requests: nothing leaks.
    core = make_core(spec_k=4)
    run_all(core, _requests(PRESETS["test-tiny"].vocab_size))
    assert core.allocator.stats().active_pages == 0


def test_draft_len_respects_max_seq_len():
    """A request near its context limit never drafts past it."""
    core = make_core(spec_k=4, params=_zero_params(), max_seq_len=16)
    req = PreprocessedRequest(token_ids=[1, 2, 3, 4], sampling=SamplingOptions(temperature=0.0),
                              stop=StopConditions(max_tokens=64, ignore_eos=True))
    toks, _ = run_all(core, [req])
    assert len(toks[0]) == 12  # capped by max_seq_len, not max_tokens
    assert core.allocator.stats().active_pages == 0


def test_rng_fold_advances_once_per_emitted_token():
    """The sample_steps handed to each verify equal the tokens emitted so far."""
    core = make_core(spec_k=4, params=_zero_params())
    calls = []
    orig = core.runner.spec_step
    core.runner.spec_step = lambda batch, v, lp_k=0: (calls.append(int(batch.sample_steps[0])),
                                                      orig(batch, v, lp_k=lp_k))[1]
    seq = core.add_request(PreprocessedRequest(token_ids=[1, 2, 3, 4],
                                               sampling=SamplingOptions(temperature=0.9, seed=11),
                                               stop=StopConditions(max_tokens=16, ignore_eos=True)))
    emitted = 0
    while core.has_work:
        before = len(calls)
        outs = core.step()
        if len(calls) > before:
            assert calls[-1] == emitted
        emitted += sum(len(o.token_ids) for _, o in outs)
    assert emitted == seq.num_generated == 16 and calls


# -- launcher ----------------------------------------------------------------------


def test_spec_and_burst_flags_and_env_are_parsed(monkeypatch):
    # The launcher's other engine knobs, at their defaults throughout.
    others = {"async_onboard": False, "constraint_lookahead_tokens": 32}
    for key in ("DYN_SPEC_K", "DYN_WORKER_SPEC_K", "DYNAMO_DECODE_STEPS", "DYN_WORKER_DECODE_STEPS",
                "DYN_OVERLAP_SPEC", "DYN_WORKER_OVERLAP_SPEC", "DYN_OVERLAP", "DYN_WORKER_OVERLAP",
                "DYN_ASYNC_ONBOARD", "DYN_CONSTRAINT_LOOKAHEAD_TOKENS"):
        monkeypatch.delenv(key, raising=False)
    assert launch._engine_env() == {"decode_steps": 1, "spec_k": 0, "overlap": False, "overlap_spec": True,
                                    **others}
    monkeypatch.setenv("DYN_WORKER_SPEC_K", "3")
    monkeypatch.setenv("DYN_WORKER_DECODE_STEPS", "8")
    monkeypatch.setenv("DYN_OVERLAP_SPEC", "0")
    assert launch._engine_env() == {"decode_steps": 8, "spec_k": 3, "overlap": False, "overlap_spec": False,
                                    **others}
    monkeypatch.setenv("DYN_SPEC_K", "2")  # the short name wins, as in the JAX launcher
    monkeypatch.setenv("DYNAMO_DECODE_STEPS", "4")
    assert launch._engine_env()["spec_k"] == 2 and launch._engine_env()["decode_steps"] == 4
    for key in ("DYN_SPEC_K", "DYNAMO_DECODE_STEPS", "DYN_WORKER_SPEC_K", "DYN_WORKER_DECODE_STEPS"):
        monkeypatch.delenv(key)

    seen = {}

    async def fake_amain(args, **kw):
        seen.update(launch._engine_env())

    monkeypatch.setattr(launch, "_amain", fake_amain)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    launch.main(["--spec-k", "4", "--decode-steps", "2", "--platform", "cpu"])
    assert (seen["spec_k"], seen["decode_steps"]) == (4, 2)
    assert "--chunk-prefill-tokens" not in launch.build_parser().format_help()


def test_engine_service_takes_spec_k_from_the_environment(monkeypatch):
    """build_engine_service builds the spec engine the environment asks for,
    with a runner whose sample buffer holds a verify of spec_k+1 columns."""
    import asyncio

    monkeypatch.setenv("DYN_SPEC_K", "3")

    async def run():
        svc = await launch.build_engine_service("test-tiny", device="cpu", num_pages=64)
        try:
            return svc.core.config.spec_k, svc.core._spec_active(), svc.core.runner._chain_buf.numel()
        finally:
            await svc.close()

    assert asyncio.run(run()) == (3, True, 64 * 4)


# -- the decode kernel's plain version past 32 query tokens ---------------------------


@pytest.mark.parametrize("t_q", [33, 100])
def test_plain_decode_past_the_cap_matches_jax_reference(t_q):
    """paged_decode_plain at T_q > 32 (the widened verify the kernel now
    takes) on gappy rows against JAX's ``paged_attention_reference``, f32
    (the algorithm, no bf16 rounding): 1e-5 relative and absolute, the
    order-of-summation gap between a one-pass softmax and split partials."""
    rng = np.random.default_rng(t_q)
    b, h, n_kv, hd, ps = 2, 8, 2, 64, 16
    lengths = [t_q + 40, 2 * t_q + 5]
    npp = -(-max(lengths) // ps)
    pages = b * npp + 1
    k = rng.standard_normal((pages, ps, n_kv * hd)).astype(np.float32)
    v = rng.standard_normal((pages, ps, n_kv * hd)).astype(np.float32)
    q = rng.standard_normal((b, t_q, h, hd)).astype(np.float32)
    tables = (1 + rng.permutation(pages - 1)[: b * npp].reshape(b, npp)).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(n, t_q, replace=False)) for n in lengths]).astype(np.int32)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                                    jnp.asarray(pos), scale=hd**-0.5))
    for splits in (1, 3):
        got = paged_decode.paged_decode_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                              torch.from_numpy(tables), torch.from_numpy(pos), scale=hd**-0.5,
                                              num_splits=splits)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert paged_decode.decode_kernel_supported(h, hd, n_kv * hd, t_q, q_dtype=torch.bfloat16,
                                                cache_dtype=torch.bfloat16)
    assert not paged_decode.decode_kernel_supported(h, hd, n_kv * hd, t_q, q_dtype=torch.float32,
                                                    cache_dtype=torch.float32)
