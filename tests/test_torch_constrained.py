"""The port's constrained decoding (``response_format: json_object``) on the
CPU, held against the JAX package (``tests/test_constrained.py`` is the JAX
side's own).

Masks and lookahead groups are bitwise the JAX build's, on the byte
tokenizer and a multi-character vocabulary, through both mask builders; the
engines' json_mode tokens equal the JAX engine's, synchronous and
overlapped, with its barrier reasons; the overlapped port dispatches the
synchronous port's compositions; spec_k and decode_steps mixes with
json_mode rows run plain steps for them; the runner picks a chained row's
mask on the device as the host would; and run_local serves a
``response_format`` request."""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from dynamo_tpu import constrained as jc
from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu_torch import constrained as tc
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import BARRIER_REASONS, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner, pack_masks
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.tokenizer import ByteTokenizer
from tests.test_constrained import _PARITY_PIECES, _PARITY_STATES, _PieceTok

PAGE = 4
EOS = (ByteTokenizer.EOS,)
_JPARAMS: dict = {}
_RUNNERS: dict = {}
_JRUNNERS: dict = {}


def jparams_for(preset):
    if preset not in _JPARAMS:
        _JPARAMS[preset] = jllama.init_params(JPRESETS[preset], 0)
    return _JPARAMS[preset]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


# -- masks -------------------------------------------------------------------

VOCABS = {"bytes": (ByteTokenizer, 259), "bpe": (_PieceTok, len(_PARITY_PIECES))}


def _cache(mod, vocab):
    tok, size = VOCABS[vocab]
    return mod.TokenMaskCache(tok(), size, EOS if vocab == "bytes" else (0,))


@pytest.mark.parametrize("vector", ["1", "0"])
@pytest.mark.parametrize("vocab", ["bytes", "bpe"])
def test_masks_and_lookahead_groups_equal_jax(monkeypatch, vocab, vector):
    """Over a corpus of machine states: every mask (plain, force-closing,
    budget-filtered), every warm peek and every lookahead grouping is
    bitwise the JAX cache's, with the same hit and miss counts, through the
    vectorized builder and the Python walk (DYN_CONSTRAINT_VECTOR_MASKS)."""
    monkeypatch.setenv("DYN_CONSTRAINT_VECTOR_MASKS", vector)
    jcache, tcache = _cache(jc, vocab), _cache(tc, vocab)
    checked = 0
    for text in _PARITY_STATES:
        js, ts = jc.advance_text(jc.MachineState(), text), tc.advance_text(tc.MachineState(), text)
        assert dataclasses.astuple(ts) == dataclasses.astuple(js), text
        if ts.mode == tc.REJECT:
            continue
        for remaining in (None, 2, 5, 40):
            for force in (False, True):
                want = jcache.mask_for(js, force_close=force, remaining=remaining)
                got = tcache.mask_for(ts, force_close=force, remaining=remaining)
                assert got.dtype == want.dtype == bool and np.array_equal(got, want), (text, remaining, force)
        for remaining in (3, 30):
            jm, tm = jc.JsonConstraint(jcache, js).mask(remaining), tc.JsonConstraint(tcache, ts).mask(remaining)
            assert np.array_equal(tm, jm)
            for cap in (2, 32):
                want, got = jcache.lookahead_groups(js, jm, cap), tcache.lookahead_groups(ts, tm, cap)
                assert (got is None) == (want is None), (text, cap)
                if got is not None:
                    assert [dataclasses.astuple(s) for s in got[0]] == [dataclasses.astuple(s) for s in want[0]]
                    assert np.array_equal(got[1], want[1])
                    for jn, tn in zip(want[0], got[0]):
                        jp, tp = jcache.peek_mask(jn, remaining - 1), tcache.peek_mask(tn, remaining - 1)
                        assert (tp is None) == (jp is None) and (tp is None or np.array_equal(tp, jp))
                    checked += 1
    assert checked > 20
    assert (tcache.hits, tcache.misses) == (jcache.hits, jcache.misses)
    assert len(tcache.drain_build_seconds()) == len(jcache.drain_build_seconds()) > 0


# -- engines -----------------------------------------------------------------


def make_core(preset="test-tiny", *, overlap=False, chunk=16, **cfg_kw):
    """A port core on the JAX build's seeded weights (one runner a preset,
    shared by the file's cores), the byte tokenizer's EOS."""
    if preset not in _RUNNERS:
        _RUNNERS[preset] = TorchModelRunner(
            PRESETS[preset], params_from_jax(_numpy_tree(jparams_for(preset)), device="cpu"),
            num_pages=96, page_size=PAGE, max_batch_size=8, prefill_bucket=16, device="cpu",
        )
    core = EngineCore(_RUNNERS[preset], EngineConfig(
        num_pages=96, page_size=PAGE, max_batch_size=8, max_seq_len=256, chunk_prefill_tokens=chunk,
        overlap=overlap, eos_token_ids=EOS, **cfg_kw))
    core.set_constraint_tokenizer(ByteTokenizer())
    return core


def jax_core(preset="test-tiny", *, chunk=16, **cfg_kw):
    """The JAX engine's core on the same weights (its runner shared too: its
    programs compile once for the file)."""
    if preset not in _JRUNNERS:
        _JRUNNERS[preset] = ModelRunner(JPRESETS[preset], jparams_for(preset), num_pages=96, page_size=PAGE,
                                        max_batch_size=8, prefill_bucket=16, attn_impl="reference")
    core = JEngineCore(_JRUNNERS[preset], JEngineConfig(num_pages=96, page_size=PAGE, max_batch_size=8, max_seq_len=256,
                                             chunk_prefill_tokens=chunk, eos_token_ids=EOS, **cfg_kw))
    core.set_constraint_tokenizer(JByteTokenizer())
    return core


def _requests(req=PreprocessedRequest, samp=SamplingOptions, stop=StopConditions, *, tail=False):
    """Four json_mode rows (greedy and seeded, budgets tight enough to force
    the close) beside a plain seeded row, admitted together; the longer
    prompts take chunked prefill. ``tail``: the first two json_mode rows and
    a plain greedy row on a repetitive prompt that outlives them."""
    tok = ByteTokenizer()
    reqs = [req(token_ids=tok.encode(f"item {i}:" + "x" * (3 * i)),
                sampling=samp(temperature=0.8 if i % 2 else 0.0, seed=i, json_mode=i != 2),
                stop=stop(max_tokens=18 + 5 * i)) for i in range(2 if tail else 5)]
    if tail:
        reqs.append(req(token_ids=[5, 7, 9] * 4, sampling=samp(temperature=0.0), stop=stop(max_tokens=40)))
    return reqs


def run_all(core, reqs, max_steps=500):
    out = {core.add_request(r).seq_id: [] for r in reqs}
    steps = 0
    while core.has_work and steps < max_steps:
        for seq, o in core.step():
            out[seq.seq_id].extend(o.token_ids)
        steps += 1
    assert not core.has_work, "engine did not drain"
    return out


def _json_texts(out, reqs):
    tok = ByteTokenizer()
    return [tok.decode([t for t in toks if t not in EOS]) for toks, r in zip(out.values(), reqs)
            if r.sampling.json_mode]


def test_json_mode_tokens_equal_the_jax_engine():
    """Synchronous engines on the same weights: the same tokens, and every
    constrained output parses (random weights: the force-close holds)."""
    want = run_all(jax_core(), _requests(JRequest, JSampling, JStop))
    core = make_core()
    got = run_all(core, _requests())
    assert got == want
    texts = _json_texts(got, _requests())
    assert len(texts) == 4 and all(json.loads(t) is not None or t.strip() == "null" for t in texts)
    assert core.constraint_mask_cache_misses > 0 and core.constraint_mask_cache_hits > 0


def _dispatch_log(core, monkeypatch):
    """Every runner dispatch's composition: (tokens fed from the host past
    column 0, positions, padded-to shapes), until ``monkeypatch.undo()``."""
    log = []
    r = core.runner
    for name in ("step", "step_async", "spec_step", "spec_step_async", "multi_step"):
        fn = getattr(r, name)

        def spy(sb, *a, _fn=fn, _name=name, **kw):
            log.append((_name.replace("_async", ""), sb.tokens[:, 1:].tolist(), sb.positions.tolist(),
                        sb.block_tables.shape))
            return _fn(sb, *a, **kw)

        monkeypatch.setattr(r, name, spy)
    return log


@pytest.mark.parametrize("preset,lookahead", [("test-tiny", 32), ("test-tiny", 0), ("test-tiny-mla", 32)])
def test_overlapped_constrained_serve_is_the_sync_serve(monkeypatch, preset, lookahead):
    """The overlapped port: tokens bitwise the synchronous port's, each
    dispatch the synchronous one's rows, positions and shapes, and on
    test-tiny the JAX overlapped engine's tokens, barrier reasons and counts
    (lookahead 32: "constraint_miss" while masks warm; 0: "constraint")."""
    sync = make_core(preset, constraint_lookahead_tokens=lookahead)
    sync_log = _dispatch_log(sync, monkeypatch)
    want = run_all(sync, _requests())
    monkeypatch.undo()
    over = make_core(preset, overlap=True, constraint_lookahead_tokens=lookahead)
    over_log = _dispatch_log(over, monkeypatch)
    got = run_all(over, _requests())
    monkeypatch.undo()
    assert got == want and over_log == sync_log
    if preset == "test-tiny":
        jover = jax_core(preset, overlap=True, constraint_lookahead_tokens=lookahead)
        assert run_all(jover, _requests(JRequest, JSampling, JStop)) == got
        assert over.overlap_barrier_counts == jover.overlap_barrier_counts
        assert over.overlap_step_counts == jover.overlap_step_counts
    assert set(over.overlap_barrier_counts) <= set(BARRIER_REASONS)
    if lookahead:
        assert over.overlap_step_counts["overlapped"] > 0 and over.overlap_barrier_counts.get("constraint_miss")
    else:
        assert over.overlap_step_counts["overlapped"] == 0
        assert over.overlap_barrier_counts["constraint"] == over.overlap_step_counts["barrier"]


@pytest.mark.parametrize("mix", ["spec_k", "decode_steps"])
def test_spec_and_burst_mixes_with_json_rows(monkeypatch, mix):
    """spec_k 4 / decode_steps 4 beside json_mode rows: constrained rows draft
    nothing and never burst (a batch holding one runs a plain masked step,
    the plain row verifies or bursts once they are gone), the tokens of the
    synchronous and the overlapped port equal the JAX engine's plain run, and the
    overlapped spec engine dispatches the synchronous one's compositions
    (an overlapped burst is chained sub-steps instead)."""
    kw = dict(spec_k=4) if mix == "spec_k" else dict(decode_steps=4)
    # Both are lossless in both packages: the JAX engine's plain run is the
    # reference (its programs compile once for the file).
    want = run_all(jax_core(), _requests(JRequest, JSampling, JStop, tail=True))
    sync = make_core(**kw)
    sync_log = _dispatch_log(sync, monkeypatch)
    assert run_all(sync, _requests(tail=True)) == want
    monkeypatch.undo()
    over = make_core(overlap=True, **kw)
    over_log = _dispatch_log(over, monkeypatch)
    assert run_all(over, _requests(tail=True)) == want
    monkeypatch.undo()
    kinds = {kind for kind, *_ in sync_log}
    assert kinds == ({"step", "spec_step"} if mix == "spec_k" else {"step", "multi_step"})
    if mix == "spec_k":
        assert over_log == sync_log and sync.spec_tokens_accepted > 0
    else:
        assert over.overlap_step_counts["overlapped"] > 0


def _decode_batch(tokens):
    """A greedy decode step of ``tokens`` (one a row) at position 5."""
    rows = len(tokens)
    tables = np.arange(1, 2 * rows + 1, dtype=np.int32).reshape(rows, 2)
    return StepBatch(tokens=np.asarray(tokens, np.int32)[:, None], positions=np.full((rows, 1), 5, np.int32),
                     block_tables=tables, slot_mapping=tables[:, 1:] * PAGE + 1,
                     last_token_index=np.zeros(rows, np.int32), temperature=np.zeros(rows, np.float32),
                     top_k=np.zeros(rows, np.int32), top_p=np.ones(rows, np.float32),
                     seeds=np.zeros(rows, np.uint32), sample_steps=np.ones(rows, np.int32),
                     freq_pen=np.zeros(rows, np.float32), pres_pen=np.zeros(rows, np.float32),
                     pos_limit=np.full(rows, 100, np.int32), history=np.full((rows, 1), -1, np.int32))


def test_chained_lookahead_mask_is_picked_on_the_device():
    """A chained step with lookahead groups samples exactly as a step given
    the mask the host would pick for each row's chained token."""
    runner = make_core().runner
    vocab, rng = runner.cfg.vocab_size, np.random.default_rng(3)
    chained = runner.step_async(_decode_batch([11, 12, 13])).result()[0][:, 0]  # stays on the device too
    masks = rng.random((3, 3, vocab)) < 0.3
    masks[:, 0] = True
    groups = rng.integers(0, 3, size=(3, vocab)).astype(np.int32)
    la = _decode_batch([0, 0, 0])
    la.la_masks, la.la_groups = pack_masks(masks), groups
    got = runner.step_async(la, chain=True).result()[0][:, 0]
    host = _decode_batch(chained)
    host.logit_mask = masks[np.arange(3), groups[np.arange(3), chained]]
    assert np.array_equal(got, runner.step(host))
    assert all(host.logit_mask[i, t] for i, t in enumerate(got))
    with pytest.raises(ValueError, match="chained token"):
        runner.step(la)


def test_engine_config_and_launcher_take_the_constraint_knobs(monkeypatch):
    assert EngineConfig(constraint_lookahead_tokens=8, async_onboard=True).constraint_lookahead_tokens == 8
    monkeypatch.setenv("DYN_CONSTRAINT_LOOKAHEAD_TOKENS", "7")
    assert launch._engine_env()["constraint_lookahead_tokens"] == 7
    monkeypatch.delenv("DYN_CONSTRAINT_LOOKAHEAD_TOKENS")
    assert launch._engine_env()["constraint_lookahead_tokens"] == 32
    core = make_core()
    core._constraint_tok = None
    core.set_constraint_tokenizer_factory(ByteTokenizer)
    core.warm_constraints()  # loads the tokenizer through the factory
    assert isinstance(core._constraint_tok, ByteTokenizer) and core.constraint_mask_cache_misses > 0


def test_response_format_served_over_run_local(monkeypatch):
    """response_format json_object through the HTTP stack: the worker takes
    its card's tokenizer (warmed on a thread) and the answer parses."""
    import aiohttp

    async def main():
        handles = await launch.run_local("test-tiny", port=0, device="cpu", num_pages=128, max_batch_size=4)
        try:
            core = handles["services"][0].core
            async with aiohttp.ClientSession() as s:
                body = {"model": "test-tiny", "max_tokens": 40, "temperature": 0.7, "seed": 5,
                        "response_format": {"type": "json_object"},
                        "messages": [{"role": "user", "content": "give me json"}]}
                async with s.post(f"http://127.0.0.1:{handles['port']}/v1/chat/completions", json=body) as r:
                    doc = await r.json()
            return doc, core.admission_rejections, core.constraint_mask_cache_hits
        finally:
            await launch.shutdown(handles)

    doc, rejected, masked = asyncio.run(main())
    json.loads(doc["choices"][0]["message"]["content"])
    assert rejected == 0 and masked > 0


def test_a_row_whose_candidates_are_all_eos_ships_only_the_identity_group():
    """A chained row whose token in flight can only be EOS (its plan holds no
    successor state) maps every token to group 0: the row finishes at
    harvest, and its sample is discarded."""
    core = make_core()
    seq = core.add_request(_requests()[0])
    core._inflight_adv[seq.seq_id] = (1, 1)  # its input token is in flight
    vocab = core.runner.cfg.vocab_size
    core._la_plan = {seq.seq_id: ([], np.full(vocab, -1, np.int32))}
    sb = _decode_batch([0])
    core._attach_lookahead_masks(sb, [seq])
    assert sb.la_masks.shape == (1, 1, -(-vocab // 8)) and (sb.la_masks == 0xFF).all()
    assert not sb.la_groups.any()
