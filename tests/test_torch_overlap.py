"""The port's overlapped engine pipeline on the CPU (the port's counterpart of
``tests/test_overlap.py``).

The contract: with ``overlap=True`` the engine emits bit-identical tokens and
logprobs to ``overlap=False``, greedy and seeded, with chunked prefill,
staggered admission, penalized rows and late-detected stops, because the
depth-1 pipeline only changes WHEN tokens cross to the host, never what was
sampled. The port's overlap is also held against the JAX engine's
synchronous path on the same parameters (``bridge.params_from_jax``), and the
port's ``_apply_chain`` against JAX's on random inputs.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner, _apply_chain as jax_apply_chain
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import BARRIER_REASONS, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner, _apply_chain
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.protocols.common import FinishReason, PreprocessedRequest, SamplingOptions, StopConditions

import torch

PAGE = 4
_JPARAMS: dict = {}
_RUNNERS: dict = {}


def jparams_for(preset):
    if preset not in _JPARAMS:
        _JPARAMS[preset] = jllama.init_params(JPRESETS[preset], 0)
    return _JPARAMS[preset]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def make_core(preset="test-tiny", *, overlap=False, chunk=16, num_pages=96, max_batch=8, max_seq_len=256,
              eos=(), **cfg_kw):
    # One runner per preset, shared by every core of the file: the sync and
    # overlapped runs of each parity pair go through the same runner. A fresh
    # EngineCore owns the page pool anew; stale KV in recycled pages is
    # rewritten by prefill before anything attends to it.
    if preset not in _RUNNERS:
        _RUNNERS[preset] = TorchModelRunner(
            PRESETS[preset], params_from_jax(_numpy_tree(jparams_for(preset)), device="cpu"),
            num_pages=num_pages, page_size=PAGE, max_batch_size=max_batch, prefill_bucket=16, device="cpu",
        )
    return EngineCore(_RUNNERS[preset], EngineConfig(
        num_pages=num_pages, page_size=PAGE, max_batch_size=max_batch, max_seq_len=max_seq_len,
        chunk_prefill_tokens=chunk, overlap=overlap, eos_token_ids=tuple(eos), **cfg_kw,
    ))


def run_all(core, reqs, max_steps=400, at_step=None):
    """Drive to completion; returns ({seq_id: tokens}, {seq_id: logprobs}).
    ``at_step(core, step)`` runs before each step."""
    tokens, lps = {}, {}
    for req in reqs:
        seq = core.add_request(req)
        tokens[seq.seq_id] = []
        lps[seq.seq_id] = []
    steps = 0
    while core.has_work and steps < max_steps:
        if at_step is not None:
            for seq in at_step(core, steps):
                tokens[seq.seq_id] = []
                lps[seq.seq_id] = []
        for seq, out in core.step():
            tokens[seq.seq_id].extend(out.token_ids)
            if out.logprobs:
                lps[seq.seq_id].extend(out.logprobs)
        steps += 1
    assert not core.has_work, "engine did not drain"
    return tokens, lps


def _requests(vocab, req=PreprocessedRequest, samp=SamplingOptions, stop=StopConditions):
    """Greedy + seeded + logprobs + chunked prefill riding the same engine."""
    return [
        req(token_ids=[5, 7, 5, 7, 5, 7, 9, 11], sampling=samp(temperature=0.0),
            stop=stop(max_tokens=14, ignore_eos=True)),
        # Long prompt: its chunked prefill rides mixed steps while the first
        # request decodes.
        req(token_ids=[i % (vocab - 2) + 1 for i in range(26)],
            sampling=samp(temperature=0.8, seed=42, logprobs=3), stop=stop(max_tokens=10, ignore_eos=True)),
        req(token_ids=[3, 3, 3, 3, 2, 1], sampling=samp(temperature=0.7, seed=7),
            stop=stop(max_tokens=10, ignore_eos=True)),
    ]


def _parity(preset, reqs, **kw):
    """Sync and overlapped runs of ``reqs()``: (sync tokens, overlapped
    tokens, sync logprobs, overlapped logprobs, the overlapped core)."""
    base_tok, base_lp = run_all(make_core(preset, **kw), reqs())
    core = make_core(preset, overlap=True, **kw)
    over_tok, over_lp = run_all(core, reqs())
    return base_tok, over_tok, base_lp, over_lp, core


# -- bit parity --------------------------------------------------------------


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
def test_overlap_is_bit_identical(preset):
    vocab = PRESETS[preset].vocab_size
    base_tok, over_tok, base_lp, over_lp, core = _parity(preset, lambda: _requests(vocab))
    assert over_tok == base_tok
    assert over_lp == base_lp and any(over_lp.values())
    assert core.overlap_step_counts["overlapped"] > 0  # the path engaged
    assert core.mixed_steps > 0
    assert core.allocator.stats().active_pages == 0


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
def test_overlap_tokens_equal_jax_sync(preset):
    """The port overlapped against the JAX engine synchronous, same
    parameters: greedy and seeded tokens bitwise (the JAX engine's own
    overlap is held to that same synchronous path)."""
    vocab = PRESETS[preset].vocab_size
    jrunner = ModelRunner(JPRESETS[preset], jparams_for(preset), num_pages=96, page_size=PAGE, max_batch_size=8,
                          prefill_bucket=16, attn_impl="reference")
    jcore = JEngineCore(jrunner, JEngineConfig(num_pages=96, page_size=PAGE, max_batch_size=8, max_seq_len=256,
                                               chunk_prefill_tokens=16))
    want, _ = run_all(jcore, _requests(vocab, JRequest, JSampling, JStop))
    core = make_core(preset, overlap=True)
    got, _ = run_all(core, _requests(vocab))
    assert got == want
    assert core.overlap_step_counts["overlapped"] > 0


def test_overlap_bit_identical_with_staggered_admission():
    """A request admitted mid-decode rides the pipeline; every stream stays
    bit-identical and every barrier step names its reason."""
    vocab = PRESETS["test-tiny"].vocab_size
    late = _requests(vocab)[2]

    def admit(core, step):
        return [core.add_request(late)] if step == 6 else []

    def run(overlap):
        core = make_core(overlap=overlap)
        return run_all(core, _requests(vocab)[:2], at_step=admit), core

    (base, base_lp), _ = run(False)
    (over, over_lp), core = run(True)
    assert over == base and over_lp == base_lp
    assert len(over) == 3
    assert core.overlap_step_counts["overlapped"] > 0
    assert sum(core.overlap_barrier_counts.values()) == core.overlap_step_counts["barrier"]
    assert set(core.overlap_barrier_counts) <= set(BARRIER_REASONS) - {"runner", "prefill"}
    assert core.allocator.stats().active_pages == 0


# -- late stops --------------------------------------------------------------


LATE_PROMPT = [1, 2, 3, 4]  # test-tiny's greedy reply to it first emits a new token at 7, 9 and 12


def _greedy_stream(n=16):
    """The model's greedy continuation of ``LATE_PROMPT``."""
    toks, _ = run_all(make_core(), [PreprocessedRequest(
        token_ids=LATE_PROMPT, sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n, ignore_eos=True),
    )])
    return next(iter(toks.values()))


def _spy_writes(monkeypatch, core):
    """Record every dispatched batch's real positions beside its rows' limits."""
    seen = []
    orig = core.runner.step_async

    def spy(batch, lp_k=0, *, chain=False, chain_src=None):
        for i in range(batch.batch_size):
            n = int(batch.last_token_index[i]) + 1
            seen.append((batch.positions[i, :n].copy(), int(batch.pos_limit[i])))
        return orig(batch, lp_k, chain=chain, chain_src=chain_src)

    monkeypatch.setattr(core.runner, "step_async", spy)
    return seen


@pytest.mark.parametrize("how", ["stop_token", "eos"])
def test_late_stop_parity_no_leak_no_overrun(monkeypatch, how):
    """A stop detected one step behind the pipeline: the in-flight chained
    step has computed the over-run token, which is never emitted; every page
    is released; a survivor's stream continues bit-identically; and no
    dispatched column lies at or past its row's position limit."""
    stream = _greedy_stream()
    stop_tok = next(t for i, t in enumerate(stream) if stream.index(t) == i and i >= 4)
    stop_kw = dict(stop_token_ids=[stop_tok]) if how == "stop_token" else {}

    def reqs():
        return [
            PreprocessedRequest(token_ids=LATE_PROMPT, sampling=SamplingOptions(temperature=0.0),
                                stop=StopConditions(max_tokens=16, ignore_eos=how != "eos", **stop_kw)),
            PreprocessedRequest(token_ids=[3, 3, 3, 3, 2, 1], sampling=SamplingOptions(temperature=0.7, seed=7),
                                stop=StopConditions(max_tokens=12, ignore_eos=True)),
        ]

    eos = (stop_tok,) if how == "eos" else ()
    base_tok, _ = run_all(make_core(eos=eos), reqs())
    core = make_core(overlap=True, eos=eos)
    seen = _spy_writes(monkeypatch, core)
    over_tok, _ = run_all(core, reqs())
    first, second = over_tok.values()
    assert over_tok == base_tok
    assert first == stream[: stream.index(stop_tok) + 1]  # never the over-run token
    assert len(second) == 12
    assert core.overlap_step_counts["overlapped"] > 0
    assert core.allocator.stats().active_pages == 0
    assert seen and all((pos < limit).all() for pos, limit in seen)


# -- compositions that chain -------------------------------------------------


def test_penalized_sampling_chains():
    """Penalized rows chain: the chained token's history entry is written
    on the device, so the penalties see what the synchronous loop sees."""
    def reqs():
        return [PreprocessedRequest(
            token_ids=[5, 7, 5, 7, 9, 11],
            sampling=SamplingOptions(temperature=0.8, seed=3, frequency_penalty=0.5, presence_penalty=0.3,
                                     logprobs=2),
            stop=StopConditions(max_tokens=12, ignore_eos=True),
        ), PreprocessedRequest(
            token_ids=[9, 9, 8], sampling=SamplingOptions(temperature=0.0, presence_penalty=1.5),
            stop=StopConditions(max_tokens=9, ignore_eos=True),
        )]

    base_tok, over_tok, base_lp, over_lp, core = _parity("test-tiny", reqs)
    assert over_tok == base_tok and over_lp == base_lp
    assert core.overlap_step_counts["overlapped"] > 0  # penalties chained
    assert core.allocator.stats().active_pages == 0


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
def test_budget_clamped_final_token_chains(preset):
    """A row finishing on its token budget mid-pipeline barriers nothing and
    corrupts no survivor."""
    vocab = PRESETS[preset].vocab_size

    def reqs():
        return [
            PreprocessedRequest(token_ids=[5, 7, 5, 7, 9, 11], sampling=SamplingOptions(temperature=0.0),
                                stop=StopConditions(max_tokens=3, ignore_eos=True)),
            PreprocessedRequest(token_ids=[i % (vocab - 2) + 1 for i in range(9)],
                                sampling=SamplingOptions(temperature=0.7, seed=13, logprobs=2),
                                stop=StopConditions(max_tokens=14, ignore_eos=True)),
        ]

    base_tok, over_tok, base_lp, over_lp, core = _parity(preset, reqs)
    assert over_tok == base_tok and over_lp == base_lp
    assert [len(t) for t in over_tok.values()] == [3, 14]
    assert core.overlap_step_counts["overlapped"] > core.overlap_step_counts["barrier"]
    assert core.allocator.stats().active_pages == 0


def test_cancellation_barriers_with_reason_cancel():
    """A request cancelled with a step in flight: the step barriers with
    reason "cancel" (its writes for the reaped row are stale), the survivor's
    stream is bit-identical to the synchronous run's, the cancelled one a
    prefix of it, and no page leaks."""
    vocab = PRESETS["test-tiny"].vocab_size

    def cancel(core, step):
        if step == 8:
            next(s for s in core.running if s.request.sampling.seed == 7).context.stop_generating()
        return []

    def reqs():
        return [_requests(vocab)[0], _requests(vocab)[2]]

    base, _ = run_all(make_core(), reqs(), at_step=cancel)
    core = make_core(overlap=True)
    over, _ = run_all(core, reqs(), at_step=cancel)
    (b0, b1), (o0, o1) = base.values(), over.values()
    assert o0 == b0 and len(o0) == 14
    assert 0 < len(o1) < 10 and b1[: len(o1)] == o1
    assert core.overlap_barrier_counts.get("cancel", 0) >= 1
    assert core.allocator.stats().active_pages == 0


def test_failed_dispatch_aborts_the_pipeline(monkeypatch):
    """A dispatch that raises inside step_async fails its rows AND the rows
    still in flight, resets the chain, and leaks no page; the engine then
    serves a new request."""
    vocab = PRESETS["test-tiny"].vocab_size
    core = make_core(overlap=True)
    seqs = [core.add_request(r) for r in _requests(vocab)]
    orig, calls = core.runner.step_async, []

    def flaky(batch, lp_k=0, *, chain=False, chain_src=None):
        calls.append(chain)
        if len(calls) == 5:
            raise RuntimeError("injected dispatch failure")
        return orig(batch, lp_k, chain=chain, chain_src=chain_src)

    monkeypatch.setattr(core.runner, "step_async", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        for _ in range(20):
            core.step()
    assert calls[3]  # the pipeline was chained when the dispatch failed
    assert all(s.finish_reason is FinishReason.ERROR for s in seqs)
    assert core._inflight is None and core.runner.chain_len() == 0
    assert core.allocator.stats().active_pages == 0
    assert not core.has_work
    monkeypatch.setattr(core.runner, "step_async", orig)
    toks, _ = run_all(core, [_requests(vocab)[0]])
    assert len(next(iter(toks.values()))) == 14


# -- the chain gather against JAX's ------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_chain_equals_jax(seed):
    """Random tokens, histories, rng counters (0 included: the history write
    clamps to index 0) and chain sources (-1 = host-fed) through both."""
    rng = np.random.default_rng(seed)
    b, t, h, nbuf = 8, int(rng.integers(1, 5)), int(rng.integers(1, 9)), 16
    tokens = rng.integers(0, 1000, (b, t)).astype(np.int32)
    history = rng.integers(-1, 1000, (b, h)).astype(np.int32)
    steps = rng.integers(0, h + 2, b).astype(np.int32)
    buf = rng.integers(0, 1000, nbuf).astype(np.int32)
    src = np.where(rng.random(b) < 0.3, -1, rng.integers(0, nbuf, b)).astype(np.int32)
    want = jax_apply_chain(*(jnp.asarray(a) for a in (tokens, history, steps, buf, src)))
    got = _apply_chain(*(torch.from_numpy(a) for a in (tokens, history, steps, buf, src)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- launcher ----------------------------------------------------------------


def test_launch_resolves_overlap(monkeypatch):
    """DYN_OVERLAP, DYN_WORKER_OVERLAP and --overlap reach EngineConfig.overlap."""
    for var in ("DYN_OVERLAP", "DYN_WORKER_OVERLAP"):
        monkeypatch.delenv(var, raising=False)

    async def overlap_of_service():
        svc = await launch.build_engine_service("test-tiny", device="cpu", num_pages=16, max_batch_size=2)
        try:
            return svc.core.config.overlap
        finally:
            await svc.close()

    assert asyncio.run(overlap_of_service()) is False
    monkeypatch.setenv("DYN_OVERLAP", "1")
    assert asyncio.run(overlap_of_service()) is True
    monkeypatch.delenv("DYN_OVERLAP")
    monkeypatch.setenv("DYN_WORKER_OVERLAP", "true")
    assert asyncio.run(overlap_of_service()) is True
    monkeypatch.delenv("DYN_WORKER_OVERLAP")
    assert launch.build_parser().parse_args([]).overlap is False

    seen = {}

    async def fake_amain(args, **_):
        seen["overlap"] = launch._overlap()

    monkeypatch.setattr(launch, "_amain", fake_amain)
    launch.main(["--overlap", "--platform", "cpu"])
    assert seen == {"overlap": True}


def _long_prompts(vocab):
    """Prompts that take several steps at a prefill budget of 24 tokens."""
    return [PreprocessedRequest(token_ids=[(7 * i + j) % (vocab - 2) + 1 for j in range(n)],
                                sampling=SamplingOptions(temperature=0.0), stop=StopConditions(max_tokens=6,
                                                                                               ignore_eos=True))
            for i, n in enumerate((10, 30, 45, 12))]


@pytest.mark.parametrize("mix", ["requests", "long_prompts"])
def test_overlap_dispatches_the_sync_compositions(monkeypatch, mix):
    """Each overlapped dispatch carries exactly the rows, positions and
    padded shapes of the synchronous dispatch at the same point (page ids
    aside): on the card, where a row's arithmetic depends on the batch's
    shapes, that is what keeps the streams bit-identical. The long prompts
    admit over several steps, where the step after a final chunk must take
    the chunk budget, as the synchronous step does."""
    vocab = PRESETS["test-tiny"].vocab_size
    reqs = _requests if mix == "requests" else _long_prompts
    kw = {} if mix == "requests" else dict(max_prefill_tokens=24, chunk=8)

    def record(core, name):
        seen, orig = [], getattr(core.runner, name)

        def spy(batch, *args, **kw):
            padded = core.runner._pad(batch)
            seen.append((padded.tokens.shape, padded.block_tables.shape, padded.positions.tolist(),
                         padded.last_token_index.tolist(), padded.sample_steps.tolist()))
            return orig(batch, *args, **kw)

        monkeypatch.setattr(core.runner, name, spy)
        return seen

    sync, over = make_core(**kw), make_core(overlap=True, **kw)
    want, got = record(sync, "step"), record(over, "step_async")
    run_all(sync, reqs(vocab))
    run_all(over, reqs(vocab))
    monkeypatch.undo()
    assert got == want and len(got) > 5


# -- runner ------------------------------------------------------------------


def test_graphs_need_the_card():
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        TorchModelRunner(PRESETS["test-tiny"], {}, num_pages=4, page_size=4, device="cpu", graphs=True)


def test_launches_recorded_by_a_capture_count_at_each_replay():
    """A wrapper's launch inside a capture is tallied apart (a capture runs
    nothing); each replay adds the tally to the module's counter."""
    from dynamo_tpu_torch.ops import build
    from dynamo_tpu_torch.ops import paged_decode as pd

    before = pd.launches
    with build.capture_launches() as tally:
        build.count_launch(vars(pd), "launches")
        build.count_launch(vars(pd), "launches")
    assert pd.launches == before and tally == {(pd.__name__, "launches"): 2}
    build.add_launches(tally)
    build.add_launches(tally)
    build.count_launch(vars(pd), "launches")
    assert pd.launches == before + 5
    pd.launches = before


def test_concurrent_captures_hold_the_collector_off(monkeypatch):
    """Two runners capture on one card from two threads: the second waits
    on the capture lock while the first captures, and each captures with
    the cyclic collector off; the collector is on again after both."""
    import contextlib
    import gc
    import threading
    import time
    import types

    seen = []
    first_inside, release = threading.Event(), threading.Event()

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        seen.append((threading.current_thread().name, gc.isenabled()))
        if threading.current_thread().name == "first":
            first_inside.set()
            assert release.wait(5)
        yield
        seen.append((threading.current_thread().name, gc.isenabled()))

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())

    def capture():
        runner = types.SimpleNamespace(device="cpu", _side=stream, _body=lambda buf, key, chain: (None, {}),
                                       _warm_chain=None, _chain_buf=None, _pool=None, _graphs={},
                                       capture_seconds=0.0)
        TorchModelRunner._capture(runner, ("decode",), None)

    was_enabled = gc.isenabled()
    gc.enable()
    try:
        first = threading.Thread(target=capture, name="first")
        second = threading.Thread(target=capture, name="second")
        first.start()
        assert first_inside.wait(5)
        second.start()
        time.sleep(0.05)  # the second thread reaches the lock
        release.set()
        first.join(5)
        second.join(5)
        assert [name for name, _ in seen] == ["first", "first", "second", "second"]
        assert not any(enabled for _, enabled in seen), seen
        assert gc.isenabled()
    finally:
        if not was_enabled:
            gc.disable()


def test_step_async_handles_survive_slot_reuse():
    """Three dispatches before any harvest: the pipeline's two pinned slots
    are reused, and each handle still returns its own step's tokens (the
    synchronous steps' on a second runner)."""
    cfg = PRESETS["test-tiny"]
    params = params_from_jax(_numpy_tree(jparams_for("test-tiny")), device="cpu")
    runners = [TorchModelRunner(cfg, params, num_pages=16, page_size=PAGE, max_batch_size=4, prefill_bucket=16,
                                device="cpu") for _ in range(2)]
    rng = np.random.default_rng(4)
    steps = []
    for k in range(3):
        b = 2
        pos = np.full((b, 1), k, np.int32)
        tables = np.array([[1, 2], [3, 4]], np.int32)
        steps.append(StepBatch(
            tokens=rng.integers(1, cfg.vocab_size, (b, 1)).astype(np.int32), positions=pos, block_tables=tables,
            slot_mapping=(tables[:, :1] * PAGE + k).astype(np.int32), last_token_index=np.zeros(b, np.int32),
            temperature=np.array([0.0, 0.9], np.float32), top_k=np.zeros(b, np.int32),
            top_p=np.ones(b, np.float32), seeds=np.full(b, 5, np.uint32), sample_steps=np.full(b, k, np.int32),
            freq_pen=np.zeros(b, np.float32), pres_pen=np.zeros(b, np.float32), pos_limit=np.full(b, 8, np.int32),
            history=np.full((b, 1), -1, np.int32)))
    handles = [runners[0].step_async(sb, lp_k=2) for sb in steps]
    for h, sb in zip(handles, steps):
        toks, aux = h.result()
        want, want_aux = runners[1].step(sb, lp_k=2)
        np.testing.assert_array_equal(toks[:, 0], want)
        for key in ("logprob", "top_ids", "top_lps"):
            np.testing.assert_array_equal(aux[key], want_aux[key])
