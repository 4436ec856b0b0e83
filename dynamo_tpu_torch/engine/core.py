"""Engine core: continuous batching with stall-free mixed steps and the
overlapped pipeline (``dynamo_tpu/engine/core.py:EngineCore``).

A ``step()`` fuses decode and prefill work into ONE runner dispatch: every
running sequence contributes a 1-token decode row, and waiting or mid-prompt
sequences advance by *chunks* under a per-step token budget
(``chunk_prefill_tokens``), so a long prompt never stalls the decode stream.
``chunk_prefill_tokens=0`` keeps the legacy phase-exclusive behavior (a step
is prefill XOR decode).

- Admission: FIFO from the waiting queue under the prefill token budget and
  page availability; prefix-cache matches reduce the charge. Pages are
  allocated per chunk, so a prompt larger than the free pool admits
  incrementally. With the SLO plane (``EngineConfig.slo_sched``,
  ``sched/``) an ``AdmissionController`` reorders the queue each step by
  deadline slack over a predicted TTFT and holds back requests over their
  tenant's quota, and a ``ChunkBudgetController`` sets the chunk budget
  from the decode steps' wall times; with ``cache_aware`` the controller
  prices a request by its uncached tokens (G1 and the tiers). Off, the
  queue is never reordered: FIFO, bitwise the plane-less scheduler.
- Decode first: running sequences' next-token pages are reserved before any
  chunk is sized.
- Preemption: on page exhaustion during decode the most recently arrived
  running sequence is evicted (pages released, tokens kept) and requeued.
- Pages commit to the prefix cache as they fill, emitting KV stored events;
  eviction emits removed events (allocator.py).

- Overlap (``EngineConfig.overlap``): step N+1 is composed at the
  sequences' effective state and dispatched (``runner.step_async``) before
  step N's tokens reach the host; decode rows take their input token from
  step N's samples on the device. Stops are detected one step late, at
  harvest, and the row's in-flight token is discarded: output streams are
  bit-identical to ``overlap=False``.
- Speculative decoding (``EngineConfig.spec_k``): an n-gram proposer
  (``engine/spec.py``) drafts up to spec_k tokens a decode row, and one
  verify dispatch (``runner.spec_step``) scores them with the chunks of the
  same step; the longest draft prefix the targets replay is accepted, plus
  the bonus token after it. Lossless: streams are bit-identical to
  ``spec_k=0``. With overlap (``overlap_spec``) every step in flight is
  harvested before the next is scheduled, since a verify's acceptance (or a
  step's sample, which the next drafts read) decides every position after
  it: the overlapped spec engine composes exactly the synchronous one's
  steps, and chains each row's accepted token from the device.
- Decode bursts (``EngineConfig.decode_steps``): a pure-decode step runs
  ``decode_steps`` fused steps in one dispatch (``runner.multi_step``);
  with overlap, as many chained sub-steps behind one dispatch.
- Constrained decoding (``response_format: json_object``, ``constrained.py``):
  a json_mode row samples under its JSON machine's token mask, built on the
  host and applied on the device. A chained row's input token is still in
  flight when its step is composed, so the engine ships one mask per
  successor state of the candidates of that token
  (``constraint_lookahead_tokens`` caps them; past the cap, or on a cold
  mask, the step barriers with reason ``constraint_miss``, and with the cap
  at 0 every constrained step barriers with reason ``constraint``).
  Constrained rows draft nothing and never ride a decode burst; a batch
  holding one runs a plain step.
- KV tiers (``block_manager``, ``blocks/``): committed pages are written
  through to G2 (host RAM, cascading to G3 on disk) by a batched page read
  after the step (``flush_offloads``); admission extends its prefix match
  from the tiers and copies the pages back with one batched write, in the
  step (synchronous) or from a background fetch that lands later
  (``async_onboard``).

- Observability: every ``step()`` lands a STEP record in ``self.flight``
  (``observability/flight.py``), and a step that raises a CRASH record
  before the exception propagates; the ``sched.admit`` fault point sits at
  each admission (``runtime/faults.py``); a landed onboarding session
  records an ``engine_onboard_wait`` span (``tracing.py``).

Not ported yet, and without a config field here, so setting it fails:
sliding-window page release (``swa_free_pages``). Multimodal requests finish
with an error. The JAX core's compile tracker, device-cost fields, anomaly
sentinel, incident capture and loss accounting are not ported either
(ROADMAP A10): its STEP records carry fields the port's leave out
(``FLIGHT_KEYS_NOT_PORTED``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from dynamo_tpu_torch.engine.allocator import OutOfPagesError, PageAllocator
from dynamo_tpu_torch.engine.runner import StepBatch, next_pow2, pack_masks
from dynamo_tpu_torch.engine.sequence import SeqStatus, Sequence
from dynamo_tpu_torch.observability.flight import CRASH, STEP, FlightRecorder
from dynamo_tpu_torch.protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from dynamo_tpu_torch.protocols.kv import ForwardPassMetrics, KvCacheEvent
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.faults import FAULTS, DropFault
from dynamo_tpu_torch.tokens import DEFAULT_SALT
from dynamo_tpu_torch.tracing import record_span, trace_of

logger = logging.getLogger(__name__)

# Logprobs requests always compute this many alternatives (one bucket;
# per-request top_logprobs slices host-side). 20 = the OpenAI cap.
LOGPROBS_TOP_K = 20

# Why an overlapped engine's step ran as a barrier (the JAX build's names;
# the first reason noted within a step wins, "idle" when none was).
BARRIER_REASONS = (
    "cancel",  # cancellation reaped mid-pipeline: in-flight writes are stale
    "runner",  # runner has no step_async
    "prefill",  # legacy XOR mode: whole-prompt prefill steps carry no decodes
    "constraint",  # constrained rows with lookahead disabled (knob = 0)
    "constraint_miss",  # lookahead mask-cache miss or candidate-cap overflow
    "drain",  # every live row finishes inside the in-flight step
    "pages",  # sole candidate cannot extend: commit in-flight, then re-check
    "spec",  # speculation: the step in flight is harvested first, or spec cannot chain
    "fill",  # pipeline refill: dispatched with nothing in flight
    "idle",  # barrier step with no recorded reason (nothing dispatched)
)

# Fields of the JAX core's STEP flight records that the port's leave out:
# their sources are the device-cost plane (ROADMAP A10), which the port has
# not taken over. Every other field is recorded under the JAX name.
FLIGHT_KEYS_NOT_PORTED = frozenset({"hbm_bytes", "flops", "roofline_frac"})


@dataclasses.dataclass
class EngineConfig:
    """The JAX build's EngineConfig with the same names and defaults, less
    ``swa_free_pages``, which only the unported sliding window reads:
    passing it fails with a ``TypeError`` that names it."""

    num_pages: int = 512
    page_size: int = 16
    max_batch_size: int = 64
    max_prefill_tokens: int = 2048  # token budget per prefill step (chunked-prefill cap)
    max_seq_len: int = 4096
    eos_token_ids: tuple[int, ...] = ()
    enable_prefix_caching: bool = True
    salt: int = DEFAULT_SALT
    worker_id: int = 0
    # Fused decode steps per dispatch (DYNAMO_DECODE_STEPS): >1 amortizes
    # the host round trip, at up to decode_steps-1 wasted steps per
    # finishing sequence and K-token stream granularity.
    decode_steps: int = 1
    chunk_prefill_tokens: int = 512
    # Speculative decoding (DYN_SPEC_K): max draft tokens per decode row per
    # step, verified in one multi-token dispatch; 0 = off. Lossless: streams
    # are bit-identical to spec_k=0. Drafts are charged against
    # chunk_prefill_tokens and the decode-first page reserve covers spec_k+1
    # slots per sequence.
    spec_k: int = 0
    # SLO-native admission control (DYN_SLO_SCHED, sched/): EDF-over-
    # predicted-TTFT ordering of the waiting queue, per-tenant quotas, and
    # an ITL-driven chunk-budget controller. Off by default: FIFO intake,
    # bit-identical to the scheduler without the plane.
    slo_sched: bool = False
    # Overlapped execution (DYN_OVERLAP): a depth-1 pipeline that dispatches
    # step N+1 before step N's tokens reach the host. Mixed steps, penalized
    # rows and budget-final tokens chain; cancellation barriers. Output
    # streams are bit-identical to off.
    overlap: bool = False
    # Let speculative verify dispatches ride the overlapped pipeline
    # (DYN_OVERLAP_SPEC): each step in flight is harvested before the next is
    # scheduled (a verify's acceptance decides it), and each verify chains
    # its base token from the device. Off barriers every spec step to the
    # synchronous path; output streams are identical either way.
    overlap_spec: bool = True
    # Pipelined tier onboarding (DYN_ASYNC_ONBOARD): admission does not wait
    # for G2/G3 payload reads; a background fetch reads them and they land
    # through the batched write_pages scatter while other rows compute. The
    # row's num_cached advances only when the session lands; a fetch
    # shortfall recomputes, as the synchronous path does.
    async_onboard: bool = False
    # Cache-aware scheduling (DYN_CACHE_AWARE): the admission plane prices a
    # request by its *residual* (uncached) prefill tokens — resident G1
    # match plus the tiers' probe — so EDF slack ranks a mostly-cached long
    # prompt ahead of a cold short one and tenant buckets charge only the
    # tokens that will be computed. Policy only, and only with an admission
    # controller: off is bit-identical to full-cost pricing.
    cache_aware: bool = False
    # Constrained-decode lookahead (DYN_CONSTRAINT_LOOKAHEAD_TOKENS): the most
    # distinct successor machine states a chained json_mode row may fan out
    # to per step. Overflow or a cold mask barriers that step (reason
    # "constraint_miss"); 0 barriers every constrained step ("constraint").
    constraint_lookahead_tokens: int = 32


@dataclasses.dataclass
class _InflightStep:
    """A dispatched-but-unharvested step: kind "step" (a possibly mixed
    step) or "spec" (a speculative verify). ``ns``/``samples``/``drafts``
    snapshot the composition the harvest needs to apply the results: a row
    whose sequence left RUNNING meanwhile (cancelled, preempted, finished)
    is skipped and its sample discarded. ``extra`` holds the chained
    pure-decode sub-steps of a decode_steps burst, harvested in dispatch
    order, one more token a row each."""

    batch: list
    handle: object
    ns: list  # real token columns per row
    n_dec: int  # leading decode rows (the rest are prefill chunks)
    samples: list  # per row: does the engine accept its sample?
    kind: str = "step"
    drafts: list | None = None  # per decode row, its draft tokens (spec)
    v: int = 1  # verify width (spec)
    extra: list = dataclasses.field(default_factory=list)  # burst sub-step handles


@dataclasses.dataclass
class _OnboardSession:
    """An admitted row's tier onboarding in flight (``async_onboard``;
    ``dynamo_tpu/engine/core.py:_OnboardSession``). The fetch thread fills
    ``payloads``/``tiers`` and sets ``done`` (host I/O only); the engine
    thread lands the session under ``step_lock``. Cancellation drops the
    session from the engine's list: the orphaned fetch finishes into this
    object, which nothing reads, so stale payloads never land."""

    seq: Sequence
    hashes: list  # full block-hash chain of the sequence
    start: int  # first onboard block index (== resident match length)
    pages: list  # freshly allocated pages awaiting payloads
    t0: float  # session start (perf_counter), for the wait counters
    count_at_start: bool  # fold landed pages into num_cached_at_start
    payloads: list = dataclasses.field(default_factory=list)
    tiers: list = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


class EngineCore:
    """Synchronous scheduler + executor. The async service layer drives it."""

    def __init__(
        self,
        runner,
        config: EngineConfig,
        *,
        on_kv_event: Callable[[KvCacheEvent], None] | None = None,
        block_manager=None,  # blocks.KvBlockManager (the G2/G3 tiers)
        admission=None,  # sched.AdmissionController (overrides the env build)
        chunk_controller=None,  # sched.ChunkBudgetController (same)
    ) -> None:
        if runner.num_pages != config.num_pages or runner.page_size != config.page_size:
            raise ValueError("runner and engine config disagree on cache geometry")
        self.runner = runner
        self.config = config
        self.block_manager = block_manager
        self.allocator = PageAllocator(config.num_pages, config.page_size, on_event=on_kv_event)
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        # Admitted but mid-prompt: their next chunk is scheduled each step
        # before new admissions; decodable once the final chunk samples.
        self.prefilling: list[Sequence] = []
        # Composition of the latest dispatch + cumulative mixed-step stats
        # (the observable form of the stall-free invariant).
        self.last_step_info: dict = {}
        self.mixed_steps = 0
        self.stall_violations = 0
        self._next_seq_id = 0
        self._eos = set(config.eos_token_ids)
        self.num_preemptions = 0
        self.admission_rejections = 0
        # SLO admission-control plane (None => FIFO intake; the explicit
        # kwargs let tests inject configured controllers without touching
        # the environment).
        self.admission = admission
        self.chunk_controller = chunk_controller
        if config.slo_sched:
            from dynamo_tpu_torch.sched import build_admission_controller, build_chunk_controller

            if self.admission is None:
                self.admission = build_admission_controller()
            if self.chunk_controller is None and config.chunk_prefill_tokens > 0:
                self.chunk_controller = build_chunk_controller(config.chunk_prefill_tokens)
        if config.cache_aware and self.admission is not None:
            # Residual-cost admission: the EDF plane prices every waiting
            # request by its uncached prefill tokens.
            self.admission.cached_tokens_fn = self._cached_prefix_tokens
        # Last _schedule_prefill's admission outcome (flight STEP record).
        self.last_admission = {
            "admitted": 0, "deferred": 0, "deadline_slack_ms": 0.0, "cached_frac": 0.0,
        }
        # Flight recorder: the last N steps' records, for postmortems.
        self.flight = FlightRecorder()
        # Rows that were in flight when a dispatch crashed (CRASH record),
        # and the host gap between steps (STEP records).
        self._aborted_inflight = 0
        self._prev_step_end: float | None = None
        # Attention dispatch-path accounting: steps by (phase, path).
        self.attn_dispatch_counts: dict[tuple[str, str], int] = {}
        self._prompt_tokens_total = 0
        self._generated_tokens_total = 0
        # Serializes step() (executor thread) against abort_all() (event loop).
        self.step_lock = threading.RLock()
        self._head_stall_steps = 0
        # The dispatch in flight on the device, not yet consumed (overlap).
        self._inflight: _InflightStep | None = None
        # Effective-state advance for sequences with a dispatch in flight:
        # seq_id -> (cached_delta, emit_delta): the KV slots the in-flight
        # step writes for the row, and 1 iff it samples a token the host has
        # not seen yet. The scheduler and the lookahead reason at
        # num_cached + cached_delta / num_generated + emit_delta, so in-flight
        # work is never scheduled twice. Cleared when the step is consumed.
        self._inflight_adv: dict[int, tuple[int, int]] = {}
        # seq_id -> row of the latest step_async whose sample is the
        # sequence's next input token: a chained dispatch takes it on the device.
        self._chain_map: dict[int, int] = {}
        # Per step with overlap on: "overlapped" when it dispatched a chained
        # lookahead while harvesting the previous one, "barrier" otherwise,
        # and why each barrier step barriered (BARRIER_REASONS).
        self._overlap_mode: str | None = None
        self._overlap_barrier_reason: str | None = None
        self.overlap_step_counts: dict[str, int] = {"overlapped": 0, "barrier": 0}
        self.overlap_barrier_counts: dict[str, int] = {}
        # Speculative decoding: cumulative drafting and verify counters
        # (acceptance rate = accepted / proposed).
        self.spec_tokens_proposed = 0
        self.spec_tokens_accepted = 0
        self.spec_steps = 0
        self._proposer = None
        if config.spec_k > 0:
            from dynamo_tpu_torch.engine.spec import build_proposer

            self._proposer = build_proposer()
        # Tier write-through, collected per step and flushed as one batched
        # page read: after the step (direct callers), or by the service after
        # it routed the step's outputs (``defer_offloads``).
        self.pending_offloads: list[tuple[int, int]] = []  # (block_hash, page_id)
        self.defer_offloads = False
        # Async tier onboarding: live sessions, the lazy fetch pool, and the
        # JAX build's counters (overlap_frac = overlap / (overlap + stall)).
        self._onboards: list[_OnboardSession] = []
        self._onboard_pool = None
        self.onboard_sessions = 0
        self.onboard_page_counts: dict[str, int] = {}  # tier -> pages landed
        self.onboard_shortfall_pages = 0  # probed but gone at fetch: recomputed
        self._onboard_waits: list[float] = []
        self.onboard_wait_ms_sum = 0.0
        self.onboard_wait_count = 0
        self.onboard_overlap_steps = 0
        self.onboard_stall_steps = 0
        self._onboard_pending_step = False
        # Constrained decoding: the mask cache needs token text, so a
        # tokenizer (or a factory for one) is installed before json_mode
        # requests arrive; the lookahead plans of the step being composed
        # (seq_id -> (successor masks, token -> group)).
        self._constraint_tok = None
        self._constraint_tok_factory = None
        self._mask_cache = None
        self._constraint_lock = threading.Lock()
        self._la_plan: dict[int, tuple[list, np.ndarray]] = {}

    # -- request intake ----------------------------------------------------

    def add_request(self, request: PreprocessedRequest, context: Context | None = None) -> Sequence:
        context = context or Context()
        seq = Sequence.from_request(
            self._next_seq_id, request, context,
            page_size=self.config.page_size, salt=self.config.salt,
        )
        self._next_seq_id += 1
        if not request.token_ids:
            return self._reject(seq, FinishReason.ERROR)
        if len(request.token_ids) > self.config.max_seq_len - 1:
            return self._reject(seq, FinishReason.LENGTH)
        if request.sampling.json_mode:
            try:
                seq.constraint = self._make_constraint()
            except ValueError as exc:
                logger.warning("rejecting json_mode request: %s", exc)
                return self._reject(seq, FinishReason.ERROR)
        if request.mm_inputs:
            logger.warning("rejecting request %s: multimodal inputs are not ported to dynamo_tpu_torch yet",
                           request.request_id)
            return self._reject(seq, FinishReason.ERROR)
        # A prompt needing more pages than the pool holds can never be
        # scheduled; admitting it would wedge the FIFO head forever.
        usable_pages = self.config.num_pages - 1  # page 0 is the reserved null page
        pages_needed = -(-len(request.token_ids) // self.config.page_size)
        if pages_needed > usable_pages:
            logger.warning("rejecting request: prompt needs %d pages, pool holds %d",
                           pages_needed, usable_pages)
            return self._reject(seq, FinishReason.ERROR)
        self.waiting.append(seq)
        return seq

    def _reject(self, seq: Sequence, reason: FinishReason) -> Sequence:
        self.admission_rejections += 1
        seq.status = SeqStatus.FINISHED
        seq.finish_reason = reason
        return seq

    # -- constrained decoding ----------------------------------------------

    def set_constraint_tokenizer(self, tokenizer) -> None:
        self._constraint_tok = tokenizer

    def set_constraint_tokenizer_factory(self, factory) -> None:
        """Install the tokenizer source for constrained decoding, loaded by
        :meth:`warm_constraints` or, failing that, by the first json_mode
        request."""
        self._constraint_tok_factory = factory

    def _make_constraint(self):
        from dynamo_tpu_torch.constrained import JsonConstraint, TokenMaskCache

        with self._constraint_lock:
            if self._mask_cache is None:
                tok = self._constraint_tok
                if tok is None and self._constraint_tok_factory is not None:
                    tok = self._constraint_tok = self._constraint_tok_factory()
                if tok is None:
                    raise ValueError("json_mode needs a tokenizer on the engine worker")
                self._mask_cache = TokenMaskCache(tok, self.runner.cfg.vocab_size, tuple(self._eos))
            return JsonConstraint(self._mask_cache)

    def warm_constraints(self) -> None:
        """Build the vocab piece table and the hot masks off the serving
        loop (a cold 128k-vocab build takes seconds): the launcher runs this
        on a daemon thread at worker start; a json_mode request racing it
        blocks on the same lock until it finishes."""
        from dynamo_tpu_torch.constrained import MachineState, advance_text

        try:
            c = self._make_constraint()
            for prefix in ("", "{", '{"', '{"k"', '{"k":', '{"k": 1', "["):
                c.cache.mask_for(advance_text(MachineState(), prefix))
        except Exception:
            logger.debug("constraint warm-up skipped", exc_info=True)

    @property
    def constraint_mask_cache_hits(self) -> int:
        """Cumulative TokenMaskCache hits (mask builds and lookahead plans)."""
        return self._mask_cache.hits if self._mask_cache is not None else 0

    @property
    def constraint_mask_cache_misses(self) -> int:
        return self._mask_cache.misses if self._mask_cache is not None else 0

    def drain_constraint_build_seconds(self) -> list[float]:
        """Cold mask-build durations since the last call."""
        if self._mask_cache is None:
            return []
        return self._mask_cache.drain_build_seconds()

    def _constraint_masks(self, batch: list[Sequence]) -> np.ndarray | None:
        """bool[B, vocab] for a step whose input tokens the host knows:
        constrained rows get their machine's allowed set (force-closing near
        the budget), the others all-True."""
        if not any(s.constraint is not None for s in batch):
            return None
        mask = np.ones((len(batch), self.runner.cfg.vocab_size), bool)
        for i, s in enumerate(batch):
            if s.constraint is not None:
                mask[i] = s.constraint.mask(s.remaining_tokens(self.config.max_seq_len))
        return mask

    def _accept_constrained(self, seq: Sequence, tokens: list[int]) -> None:
        """Advance the row's machine; without an EOS id a completed value
        ends the sequence (with one, the mask steers the model to emit it)."""
        if seq.constraint is None:
            return
        for t in tokens:
            seq.constraint.accept(int(t))
        st = seq.constraint.state
        if not self._eos and st.complete() and st.mode == "A" and not seq.is_finished:
            self._finish(seq, FinishReason.STOP)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.prefilling or self._inflight is not None)

    # -- stepping ----------------------------------------------------------

    def step(self) -> list[tuple[Sequence, EngineOutput]]:
        """Advance the engine by one batched forward; returns per-seq deltas.

        Every step that dispatched or emitted lands a STEP record in
        ``self.flight`` (``dynamo_tpu/engine/core.py:step``, less the fields
        of ``FLIGHT_KEYS_NOT_PORTED``, plus ``onboard_stalled``), and a step
        that raises a CRASH record with the failing step's context before
        the exception propagates to the service loop (which dumps the ring
        to JSONL)."""
        with self.step_lock:
            prev_info = self.last_step_info
            disp0 = getattr(self.runner, "dispatch_seconds_total", None)
            cap0 = getattr(self.runner, "capture_seconds", None)
            t0 = time.perf_counter()
            # Host gap since the previous step returned: the window where the
            # device has nothing newly dispatched unless overlap hides it.
            gap_ms = (t0 - self._prev_step_end) * 1e3 if self._prev_step_end is not None else 0.0
            self._overlap_mode = None
            self._overlap_barrier_reason = None
            self._aborted_inflight = 0
            try:
                out = self._step_locked()
            except Exception as exc:
                self.flight.record(
                    CRASH,
                    error=type(exc).__name__,
                    detail=str(exc)[:500],
                    waiting=len(self.waiting),
                    running=len(self.running),
                    prefilling=len(self.prefilling),
                    free_pages=self.allocator.num_free(),
                    inflight_rows=self._aborted_inflight or (
                        len(self._inflight.batch) if self._inflight is not None else 0),
                    last_step_info=dict(self.last_step_info),
                )
                raise
            wall_ms = (time.perf_counter() - t0) * 1e3
            info = self.last_step_info
            fresh = info is not prev_info  # a dispatch composed this step
            onboard_stalled = False
            if self._onboard_pending_step:
                # A tier fetch was in flight across this step: did the step
                # still dispatch work (overlap) or idle on it (stall)?
                if fresh:
                    self.onboard_overlap_steps += 1
                else:
                    self.onboard_stall_steps += 1
                    onboard_stalled = True
                self._onboard_pending_step = False
            if not fresh and not out and not self.running:
                self._prev_step_end = time.perf_counter()
                return out  # idle drain: nothing dispatched, nothing to record
            overlap_mode = barrier_reason = ""
            if self.config.overlap:
                overlap_mode = self._overlap_mode or "barrier"
                self.overlap_step_counts[overlap_mode] = self.overlap_step_counts.get(overlap_mode, 0) + 1
                if overlap_mode == "barrier":
                    barrier_reason = self._overlap_barrier_reason or "idle"
                    self.overlap_barrier_counts[barrier_reason] = (
                        self.overlap_barrier_counts.get(barrier_reason, 0) + 1)
            if fresh:
                decode_rows = int(info.get("decode_rows", 0))
                chunk_rows = int(info.get("chunk_rows", 0))
                chunk_tokens = int(info.get("chunk_tokens", 0))
                spec_drafted = int(info.get("spec_drafted", 0))
                spec_accepted = int(info.get("spec_accepted", 0))
                kind = "mixed" if decode_rows and chunk_rows else ("prefill" if chunk_rows else "decode")
            else:
                decode_rows = len(self.running)
                chunk_rows = chunk_tokens = spec_drafted = spec_accepted = 0
                kind = "decode" if self.running else "drain"
            dispatch_ms = (self.runner.dispatch_seconds_total - disp0) * 1e3 if disp0 is not None else 0.0
            # Consume the runner's dispatch label, so a step that dispatched
            # nothing never re-counts the previous dispatch.
            attn = getattr(self.runner, "last_attn_dispatch", None)
            if attn is not None:
                self.runner.last_attn_dispatch = None
                self.attn_dispatch_counts[attn] = self.attn_dispatch_counts.get(attn, 0) + 1
            attn_phase, attn_path = attn if attn else ("", "")
            # Feed the chunk-budget controller only steps that carried decode
            # rows: their wall time is the ITL a running request observed,
            # less the first captures of graph keys inside the step (a
            # one-off cost the budget cannot move; fed in, the controller's
            # own shrinks would reach uncaptured keys and shrink again).
            if self.chunk_controller is not None and decode_rows:
                capture_ms = (self.runner.capture_seconds - cap0) * 1e3 if cap0 is not None else 0.0
                self.chunk_controller.observe(wall_ms - capture_ms)
            self.flight.record(
                STEP,
                step_kind=kind,
                decode_rows=decode_rows,
                chunk_rows=chunk_rows,
                chunk_tokens=chunk_tokens,
                outputs=len(out),
                waiting=len(self.waiting),
                running=len(self.running),
                prefilling=len(self.prefilling),
                free_pages=self.allocator.num_free(),
                preemptions=self.num_preemptions,
                admission_rejections=self.admission_rejections,
                mixed_steps=self.mixed_steps,
                stall_violations=self.stall_violations,
                spec_drafted=spec_drafted,
                spec_accepted=spec_accepted,
                spec_accept_rate=round(spec_accepted / spec_drafted, 4) if spec_drafted else 0.0,
                wall_ms=round(wall_ms, 3),
                dispatch_ms=round(dispatch_ms, 3),
                attn_phase=attn_phase,
                attn_path=attn_path,
                admitted=int(self.last_admission.get("admitted", 0)),
                deferred=int(self.last_admission.get("deferred", 0)),
                deadline_slack_ms=self.last_admission.get("deadline_slack_ms", 0.0),
                cached_frac=self.last_admission.get("cached_frac", 0.0),
                gap_ms=round(gap_ms, 3),
                overlap_mode=overlap_mode,
                barrier_reason=barrier_reason,
                chained_rows=int(info.get("chained_rows", 0)) if fresh else 0,
                onboard_stalled=onboard_stalled,
            )
            self._prev_step_end = time.perf_counter()
            return out

    def _step_locked(self) -> list[tuple[Sequence, EngineOutput]]:
        # Pending offloads are read before allocate() can evict their pages
        # (a no-op when the service already flushed them).
        self.flush_offloads()
        out = self._step_body()
        if not self.defer_offloads:
            self.flush_offloads()
        return out

    def _step_body(self) -> list[tuple[Sequence, EngineOutput]]:
        cancelled = self._reap_cancelled()
        if self._inflight is not None and (
            cancelled or (not self.config.overlap and (self.waiting or self.prefilling))
        ):
            # Composition is about to change. Reaping released the cancelled
            # rows' pages, so the in-flight step's writes for them are stale
            # and nothing new may be composed on top of it.
            if cancelled:
                self._note_barrier("cancel")
            return cancelled + self._drain_inflight()
        if self._inflight is not None and self._spec_active() and self._spec_chains():
            # Speculation decides every position from the step before: a
            # verify's acceptance, or a step's sample (the next drafts read
            # it). Harvest it before scheduling, so this step is composed
            # from the state the synchronous engine composes from; the
            # device-resident samples stay valid to chain from.
            self._note_barrier("spec")
            cancelled += self._harvest_inflight()
        chunks = self._schedule_prefill()
        overlap_ok, reason = self._overlap_route(chunks)
        if overlap_ok:
            return cancelled + self._run_mixed_overlapped(chunks)
        if reason is not None:
            self._note_barrier(reason)
        if self.config.overlap and self._inflight is not None:
            # Barrier with work in flight: commit it before any synchronous
            # dispatch. Chunks scheduled above keep their pages and are
            # scheduled again next step.
            return cancelled + self._drain_inflight()
        fused = self.config.chunk_prefill_tokens > 0
        if chunks or (fused and self.running and self.prefilling) or (self._spec_active() and self.running):
            # Mixed step: decode rows + prefill-chunk rows in one dispatch
            # (also with zero chunks scheduled: decode must not wait on
            # page-starved prefills). Legacy mode runs whole prompts alone.
            # With speculation on, pure-decode steps come here too: the
            # verify dispatch supersedes the decode burst.
            return cancelled + self._run_mixed(chunks)
        if self.running:
            return cancelled + self._run_decode()
        return cancelled + self._drain_inflight()

    def _reap_cancelled(self) -> list[tuple[Sequence, EngineOutput]]:
        out: list[tuple[Sequence, EngineOutput]] = []
        for q in (self.waiting, self.prefilling, self.running):
            for seq in list(q):
                if seq.context.is_stopped and seq.status is not SeqStatus.FINISHED:
                    self._finish(seq, FinishReason.CANCELLED)
                    out.append((seq, EngineOutput(
                        token_ids=[],
                        finish_reason=FinishReason.CANCELLED,
                        cumulative_tokens=seq.num_generated,
                        prompt_tokens=seq.num_prompt,
                        cached_tokens=seq.num_cached_at_start,
                    )))
        return out

    # -- overlapped pipeline routing ---------------------------------------

    def _note_barrier(self, reason: str) -> None:
        """Record why this step barriered (first reason wins)."""
        if self._overlap_barrier_reason is None:
            self._overlap_barrier_reason = reason

    def _adv(self, s: Sequence) -> tuple[int, int]:
        """(cached_delta, emit_delta) the in-flight dispatch owes ``s``."""
        return self._inflight_adv.get(s.seq_id, (0, 0))

    def _eff_cached(self, s: Sequence) -> int:
        """num_cached once the in-flight step lands."""
        return s.num_cached + self._adv(s)[0]

    def _eff_remaining(self, s: Sequence) -> int:
        """remaining_tokens at effective state, WITHOUT the live-row floor:
        <= 0 means the sequence reaches its finish line inside the in-flight
        step (it is left out of the lookahead, and the late stop check at
        harvest finishes it). Equals Sequence.remaining_tokens for rows with
        nothing in flight."""
        de = self._adv(s)[1]
        return min(
            s.request.stop.max_tokens - (s.num_generated + de),
            self.config.max_seq_len - (len(s.tokens) + de),
        )

    def _decodes_next(self, s: Sequence) -> bool:
        """A mid-prompt sequence that decodes once the in-flight step lands:
        its chunk in flight leaves at most its last prompt token, which the
        synchronous engine feeds as a decode row (it moves a sequence to
        running at ``prompt_remaining <= 1``). The JAX engine counts only a
        sampling final chunk here, and schedules a 1-token chunk where its
        synchronous step runs a decode row."""
        return self._adv(s)[0] > 0 and len(s.tokens) - self._eff_cached(s) <= 1

    def _overlap_route(self, chunks) -> tuple[bool, str | None]:
        """Decide whether this step runs the chained pipeline: (use_overlap,
        barrier_reason). The reason is None when overlap is simply off or
        idle, else it names the composition the pipeline cannot take.
        Penalties, logprobs, budget-final tokens, admission and mixed
        prefill+decode steps all chain."""
        cfg = self.config
        if not cfg.overlap:
            return False, None
        if not hasattr(self.runner, "step_async"):
            return False, "runner"
        if chunks and cfg.chunk_prefill_tokens <= 0:
            # Legacy XOR mode: whole-prompt prefill steps carry no decode
            # rows, so there is nothing to chain.
            return False, "prefill"
        rows = self.running + [s for s, _ in chunks] + [s for s in self.prefilling if self._decodes_next(s)]
        if not rows:
            # Nothing schedulable. If a step is in flight its rows are all
            # finishing: the next step harvests it; otherwise idle.
            return (self._inflight is not None), None
        if any(s.constraint is not None for s in rows):
            if cfg.constraint_lookahead_tokens <= 0:
                return False, "constraint"
            if not self._plan_constraint_lookahead(rows):
                # Cold successor mask or candidate fan-out past the cap:
                # barrier to the synchronous mask path (which warms exactly
                # the states that missed) and retry the pipeline next step.
                return False, "constraint_miss"
        if self._spec_active() and not self._spec_chains():
            # Speculation is on but cannot chain (overlap_spec off, or a
            # runner without an async verify): barrier to the synchronous
            # verify path rather than drop the drafts.
            return False, "spec"
        return True, None

    def _plan_constraint_lookahead(self, rows) -> bool:
        """Build the successor masks of every constrained row whose input
        token is still in flight (``dynamo_tpu/engine/core.py:_plan_constraint_lookahead``).
        Returns False (barrier "constraint_miss") when a plan would need a
        mask the cache cannot give warm.

        With one step unharvested, the row's machine is current through the
        token before the one in flight, so ``constraint.mask(remaining)`` is
        the mask that token is being sampled under. Every token it admits
        (less EOS, whose sample the late stop check discards) is a
        candidate; candidates collapse into successor machine states, and
        each state's mask at the row's remaining budget after the token in
        flight is one lookahead group."""
        cap = self.config.constraint_lookahead_tokens
        cache = self._mask_cache
        plan: dict[int, tuple[list, np.ndarray]] = {}
        self._la_plan = plan
        ok = True
        for s in rows:
            if s.constraint is None or not self._adv(s)[1]:
                continue  # the host knows this row's input token: its exact mask rides
            allowed = s.constraint.mask(s.remaining_tokens(self.config.max_seq_len))
            la = cache.lookahead_groups(s.constraint.state, allowed, cap)
            if la is None:
                ok = False
                continue
            states, group_of = la
            rem_next = self._eff_remaining(s)
            masks = []
            for ns in states:
                m = cache.peek_mask(ns, rem_next)
                if m is None:
                    # Cold successor: this step barriers anyway, so warm it
                    # now (a successor the stream never takes would re-miss
                    # every step it stays a candidate).
                    cache.mask_for(ns, remaining=rem_next)
                    ok = False
                masks.append(m)
            if ok:
                plan[s.seq_id] = (masks, group_of)
        return ok

    def _attach_lookahead_masks(self, sb: StepBatch, batch: list[Sequence]) -> None:
        """Ship the rows' constraint masks as lookahead groups on a chained
        dispatch: ``la_masks[i, la_groups[i, tok]]`` is row i's mask once its
        chained input token ``tok`` is on the device. Group 0 is all-True
        (unconstrained rows; EOS candidates, whose rows finish at harvest).
        The masks are bit-packed as they are gathered (``pack_masks``): the
        host never holds the B x G x vocab booleans."""
        vocab = self.runner.cfg.vocab_size
        rows: dict[int, tuple[list, np.ndarray | None]] = {}
        for i, s in enumerate(batch):
            if s.constraint is None:
                continue
            if self._adv(s)[1]:
                # Routed here only after _plan_constraint_lookahead succeeded
                # for every constrained row in flight: a missing plan is a bug.
                rows[i] = self._la_plan[s.seq_id]
            else:
                # The host knows this row's input token (a chunk row, or a
                # decode row whose token was harvested): one group holding
                # its exact mask.
                rows[i] = ([s.constraint.mask(s.remaining_tokens(self.config.max_seq_len))], None)
        g_max = 1 + max(len(masks) for masks, _ in rows.values())
        groups = np.zeros((len(batch), vocab), np.uint8 if g_max <= 255 else np.int32)
        la = np.zeros((len(batch), g_max, -(-vocab // 8)), np.uint8)
        la[:, 0] = 0xFF
        for i, (masks, group_of) in rows.items():
            if group_of is None:
                groups[i] = 1
            else:
                np.add(group_of, 1, out=groups[i], casting="unsafe")  # -1 (no candidate) -> group 0
            for g, m in enumerate(masks):  # none: every candidate is EOS, and the row finishes at harvest
                la[i, g + 1] = pack_masks(m)
        sb.la_masks = la
        sb.la_groups = groups

    def _spec_chains(self) -> bool:
        """Verify dispatches ride the overlapped pipeline."""
        return self.config.overlap and self.config.overlap_spec and hasattr(self.runner, "spec_step_async")

    # -- prefill phase -----------------------------------------------------

    def chunk_budget_tokens(self) -> int:
        """The live per-step prefill chunk budget: the ITL-driven
        controller's current value when the SLO plane runs one, else the
        static config. Never 0 when the config is nonzero (the controller
        floors at ``chunk_floor_tokens``), so chunked-vs-legacy mode never
        flips."""
        if self.chunk_controller is not None:
            return self.chunk_controller.budget()
        return self.config.chunk_prefill_tokens

    def _schedule_prefill(self) -> list[tuple[Sequence, int]]:
        """This step's prefill work as ``(sequence, num_tokens)`` chunks.

        Continues mid-prompt sequences first (arrival order), then admits
        from the waiting queue FIFO (EDF under tenant quotas with the SLO
        plane), all under the per-step token budget:
        :meth:`chunk_budget_tokens` while decodable sequences are running,
        the full ``max_prefill_tokens`` otherwise. A resumed (preempted)
        sequence recomputes everything generated so far; its final chunk's
        sample is the legitimate next token. With a block manager, the prefix
        match extends into the tiers and those pages are copied back (the
        JAX build's tier branches)."""
        # Land finished onboarding sessions first: their rows' num_cached
        # advances here, on the engine thread under step_lock.
        if self._onboards:
            self._poll_onboards(wait=False)
        ps = self.config.page_size
        chunk_budget = self.chunk_budget_tokens()
        chunked = chunk_budget > 0
        # Decodable at effective state, as the synchronous engine sees them
        # by now: running sequences that do not finish inside the in-flight
        # step (overlap), and those that decode next (_decodes_next). (The JAX
        # engine counts the running ones as they stand, so its overlapped
        # steps can take the chunk budget where its synchronous steps take
        # the whole prefill budget, and the reverse: a different
        # composition, and on the card a row's arithmetic depends on the
        # batch's shapes.)
        decodable = [s for s in self.running + [s for s in self.prefilling if self._decodes_next(s)]
                     if self._eff_remaining(s) >= 1]
        if chunked and decodable:
            budget = min(chunk_budget, self.config.max_prefill_tokens)
        else:
            budget = self.config.max_prefill_tokens
        chunks: list[tuple[Sequence, int]] = []
        # Decode first: the decodable sequences' next-token pages are spoken
        # for before any chunk is sized against the free pool. Speculation
        # widens the reserve to spec_k+1 slots per sequence: a chunk must
        # never take pages a verify row needs this step (drafts drop rather
        # than preempt, so a full pool would silently disable speculation).
        ahead = 1 + (self.config.spec_k if self._spec_active() else 0)
        reserve = sum(
            s.pages_needed(ps, self._adv(s)[0] + max(0, min(ahead, self._eff_remaining(s))))
            for s in decodable
        ) if chunked else 0

        def free_pages() -> int:
            return max(0, self.allocator.num_free() - reserve)

        # 1) Continue sequences already mid-prompt (arrival order).
        for seq in self.prefilling:
            if budget <= 0:
                break
            if self._decodes_next(seq):
                continue  # a decode row of this step (overlap)
            if seq.onboard_pending:
                # Tier payloads in flight: the cached prefix is not final,
                # so a chunk now would recompute what the session lands.
                continue
            # A chunk already in flight counts as computed (overlap): the
            # next chunk starts where the in-flight one will leave off.
            dc = self._adv(seq)[0]
            n = min(seq.prompt_remaining - dc, budget)
            n = min(n, len(seq.pages) * ps - (seq.num_cached + dc) + free_pages() * ps)
            if n <= 0:
                continue  # page-starved this step; decode still proceeds
            need = seq.pages_needed(ps, dc + n)
            if need:
                try:
                    seq.pages.extend(self.allocator.allocate(need))
                except OutOfPagesError:
                    continue
            budget -= n
            chunks.append((seq, n))

        # 2) Admit from the waiting queue. With the SLO plane attached,
        # prepare() reorders the queue EDF (least slack first) and returns how
        # many head entries clear their tenant quotas this step; without it
        # the deque is untouched (FIFO).
        admissible: int | None = None
        quota_deferred = 0
        finishing = 0  # rows that leave inside the step in flight (the plane's slot count)
        if self.admission is not None and self.waiting:
            admissible, finishing = self._prepare_admission()
            # Quota deferrals only: entries later skipped for pages, budget
            # or batch slots are resource-limited, not deferred.
            quota_deferred = len(self.waiting) - admissible
        n_admitted = 0
        admit_cached = 0  # admission-time cached tokens (resident + tiers)
        admit_total = 0  # total prompt tokens admitted this step
        while (
            self.waiting
            and budget > 0
            and (admissible is None or n_admitted < admissible)
            and len(self.running) + len(self.prefilling) - finishing < self.config.max_batch_size
        ):
            seq = self.waiting[0]
            if FAULTS.armed:
                try:
                    if FAULTS.fire("sched.admit") == "delay":
                        break  # deferred; retried next step
                except DropFault:
                    # Leave the seq in waiting but kill its context: the next
                    # step's _reap_cancelled emits CANCELLED, so the client
                    # stream terminates instead of hanging outside all queues.
                    seq.context.kill()
                    break
            total = len(seq.tokens)  # prompt + any generated-before-preemption
            matched: list[int] = []
            onboard_n = 0  # tier blocks to onboard (payloads fetched after allocation)
            hashes: list[int] = []
            if self.config.enable_prefix_caching:
                hashes = seq.block_seq.block_hashes
                matched = self.allocator.match_prefix(hashes)
                if self.block_manager is not None:
                    # Extend the match from the capacity tiers (membership only).
                    onboard_n = self.block_manager.probe_prefix(hashes, len(matched))
                # Must compute at least the final token's logits.
                while (len(matched) + onboard_n) * ps > total - 1:
                    if onboard_n:
                        onboard_n -= 1
                    else:
                        self.allocator.release([matched.pop()])
            cached_len = (len(matched) + onboard_n) * ps
            num_new = total - cached_len
            # Pipelined onboarding: admit the row with only its onboard pages
            # and no chunk; a background session fetches the payloads. Legacy
            # unchunked mode stays synchronous (no later chunk to overlap).
            async_ob = self.config.async_onboard and chunked and onboard_n > 0
            if async_ob:
                n = 0
                try:
                    new_pages = self.allocator.allocate(onboard_n)
                except OutOfPagesError:
                    self.allocator.release(matched)
                    if not chunks and not self.running:
                        self._note_head_stall(seq, num_new)
                    break
            elif chunked:
                n = min(num_new, budget)
                n = min(n, (len(matched) + free_pages()) * ps - cached_len)
                if n <= 0:
                    self.allocator.release(matched)
                    if not chunks and not self.running:
                        self._note_head_stall(seq, num_new)
                    break
            else:
                n = num_new
                if chunks and n > budget:
                    self.allocator.release(matched)
                    break
            if not async_ob:
                pages_goal = -(-(cached_len + n) // ps)
                try:
                    new_pages = self.allocator.allocate(pages_goal - len(matched))
                except OutOfPagesError:
                    self.allocator.release(matched)
                    if not chunks and not self.running:
                        self._note_head_stall(seq, num_new)
                    break
            self.waiting.popleft()
            seq.admitted_time = time.monotonic()
            n_admitted += 1
            admit_cached += cached_len
            admit_total += total
            if self.admission is not None:
                self.admission.on_admit(seq, seq.admitted_time)
            if onboard_n and not async_ob:
                # Pages exist now: fetch the payloads, copy them in, commit
                # them (they re-enter the prefix cache and re-announce). A
                # shortfall (evicted since the probe) is recomputed.
                onboard, tiers = self.block_manager.fetch_prefix_tiered(hashes, len(matched), onboard_n)
                if len(onboard) < onboard_n:
                    shortfall = onboard_n - len(onboard)
                    self.onboard_shortfall_pages += shortfall
                    onboard_n = len(onboard)
                    cached_len = (len(matched) + onboard_n) * ps
                    n += min(shortfall * ps, total - cached_len - n)
                self.block_manager.onboard(new_pages[:onboard_n], onboard)
                blocks = seq.block_seq.blocks
                for i, pid in enumerate(new_pages[:onboard_n]):
                    blk = blocks[len(matched) + i]
                    self.allocator.commit(pid, blk.block_hash, blk.parent_hash, blk.tokens)
                for tier in tiers[:onboard_n]:
                    self.onboard_page_counts[tier] = self.onboard_page_counts.get(tier, 0) + 1
            seq.pages = matched + new_pages
            seq.prefill_chunks = 0
            if async_ob:
                # The onboard region is pending: the cached state is the
                # resident match until the session lands.
                seq.committed_pages = len(matched)
                seq.num_cached = len(matched) * ps
                if seq.status is not SeqStatus.PREEMPTED:
                    seq.num_cached_at_start = seq.num_cached  # set again at landing
                self._start_onboard(seq, hashes, len(matched), new_pages,
                                    count_at_start=seq.status is not SeqStatus.PREEMPTED)
            else:
                seq.committed_pages = len(matched) + onboard_n
                seq.num_cached = cached_len
                if seq.status is not SeqStatus.PREEMPTED:
                    seq.num_cached_at_start = cached_len
            seq.status = SeqStatus.RUNNING
            self.prefilling.append(seq)
            budget -= n
            if n:
                chunks.append((seq, n))
        if chunks:
            self._head_stall_steps = 0
        elif (chunked and not self.running and len(self.prefilling) > 1 and self._inflight is None
              and not self._onboards):
            # Nothing can move: mid-prompt sequences pin every page among
            # themselves. Preempt the most recently arrived one and retry
            # (bounded by the prefilling count; a sole mid-prompt sequence
            # always fits — its prompt passed the pool check at intake).
            # With a step or an onboarding in flight, emptiness is progress
            # (its chunks or pages land soon): never preempt then.
            self._preempt(self.prefilling[-1])
            return self._schedule_prefill()
        if self._onboards and not chunks and not self.running:
            # Nothing else to run: wait briefly for the fetch instead of
            # spinning the step loop (bounded: a hung read never wedges us).
            self._poll_onboards(wait=True)
        self._onboard_pending_step = bool(self._onboards)
        self.last_admission = {
            "admitted": n_admitted,
            "deferred": quota_deferred,
            "deadline_slack_ms": round(self.admission.last_slack_ms, 3) if self.admission is not None else 0.0,
            "cached_frac": round(admit_cached / admit_total, 4) if admit_total else 0.0,
        }
        return chunks

    def _prepare_admission(self) -> tuple[int, int]:
        """``admission.prepare`` over the waiting queue at effective state:
        returns the admissible head count and how many live rows finish
        inside the step in flight.

        With a step in flight (overlap), the synchronous engine would compose
        this step after harvesting it: rows that reach their finish line
        inside it would be finished, their quota charges refunded, their
        batch slots free and out of the live count the predictor reads. So
        those rows' charges are released here, ahead of their late stop at
        harvest (``on_finish`` is idempotent), and they count neither as
        running nor against the batch cap. Without a step in flight this is
        the JAX build's call."""
        live = self.running + self.prefilling
        if self._inflight_adv:
            for s in live:
                if self._eff_remaining(s) < 1:
                    self.admission.on_finish(s)
            live = [s for s in live if self._eff_remaining(s) >= 1]
        finishing = len(self.running) + len(self.prefilling) - len(live)
        return self.admission.prepare(self.waiting, running=len(live), slots=self.config.max_batch_size), finishing

    def _note_head_stall(self, seq: Sequence, num_new: int) -> None:
        self._head_stall_steps += 1
        if self._head_stall_steps % 100 == 1:
            logger.warning(
                "head-of-queue seq %d cannot allocate pages for %d tokens "
                "(free %d pages) with nothing running; stalled %d steps",
                seq.seq_id, num_new, self.allocator.num_free(), self._head_stall_steps,
            )

    # -- async tier onboarding ---------------------------------------------

    def _start_onboard(self, seq: Sequence, hashes: list, start: int, pages: list, *,
                       count_at_start: bool) -> None:
        if self._onboard_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # Pool width bounds how many tier fetches overlap the steps.
            width = max(1, int(os.environ.get("DYN_ONBOARD_POOL_WIDTH", "2")))
            self._onboard_pool = ThreadPoolExecutor(max_workers=width, thread_name_prefix="kv-onboard")
        sess = _OnboardSession(seq=seq, hashes=list(hashes), start=start, pages=list(pages),
                               t0=time.perf_counter(), count_at_start=count_at_start)
        seq.onboard_pending = len(pages)
        self._onboards.append(sess)
        self.onboard_sessions += 1
        self._onboard_pool.submit(self._onboard_fetch, sess)

    def _onboard_fetch(self, sess: _OnboardSession) -> None:
        """Background thread: tier reads only, never scheduler state nor the
        card. A failure degrades to an empty fetch (the row recomputes)."""
        try:
            sess.payloads, sess.tiers = self.block_manager.fetch_prefix_tiered(
                sess.hashes, sess.start, len(sess.pages))
        except Exception:
            logger.exception("tier fetch failed for seq %d; onboarding degrades to recompute", sess.seq.seq_id)
            sess.payloads, sess.tiers = [], []
        finally:
            sess.done.set()

    def _cancel_onboards(self, seq: Sequence) -> None:
        """Forget any session of ``seq`` (preempted or finished): its pages
        are released, so a later landing would write into reused pages."""
        if self._onboards:
            self._onboards = [s for s in self._onboards if s.seq is not seq]
        seq.onboard_pending = 0

    def _poll_onboards(self, *, wait: bool) -> None:
        """Land finished sessions (engine thread, under step_lock); ``wait``
        blocks briefly on the oldest one."""
        if wait and self._onboards:
            self._onboards[0].done.wait(timeout=0.05)
        rest: list[_OnboardSession] = []
        for sess in self._onboards:
            if sess.done.is_set():
                self._land_onboard(sess)
            else:
                rest.append(sess)
        self._onboards = rest

    def _land_onboard(self, sess: _OnboardSession) -> None:
        """Apply a finished session: the batched write to the card, the
        prefix-cache commit and the row's num_cached advance. A shortfall
        leaves the trailing pages as plain pages that the next chunks
        compute, as on the synchronous path."""
        seq = sess.seq
        wait_s = time.perf_counter() - sess.t0
        self._onboard_waits.append(wait_s)
        self.onboard_wait_ms_sum += wait_s * 1e3
        self.onboard_wait_count += 1
        # The request's onboard segment: the fetch ran in the background, so
        # only the session's measured wait is on its critical path.
        record_span("engine_onboard_wait", round(wait_s * 1e3, 3), trace=trace_of(seq.context),
                    request_id=seq.request.request_id, pages=len(sess.pages))
        if seq.status is not SeqStatus.RUNNING or seq not in self.prefilling:
            seq.onboard_pending = 0  # finished or preempted meanwhile
            return
        ps = self.config.page_size
        expected = len(sess.pages)
        landed = min(len(sess.payloads), expected)
        if landed:
            self.block_manager.onboard(sess.pages[:landed], sess.payloads[:landed])
            blocks = seq.block_seq.blocks
            for i, pid in enumerate(sess.pages[:landed]):
                blk = blocks[sess.start + i]
                self.allocator.commit(pid, blk.block_hash, blk.parent_hash, blk.tokens)
            for tier in sess.tiers[:landed]:
                self.onboard_page_counts[tier] = self.onboard_page_counts.get(tier, 0) + 1
        if landed < expected:
            self.onboard_shortfall_pages += expected - landed
        seq.num_cached += landed * ps
        seq.committed_pages += landed
        if sess.count_at_start:
            seq.num_cached_at_start = seq.num_cached
        seq.onboard_pending = 0

    def drain_onboard_waits(self) -> list[float]:
        """The session wait times (seconds) since the last call."""
        out, self._onboard_waits = self._onboard_waits, []
        return out

    def _cached_prefix_tokens(self, seq: Sequence) -> int:
        """Admission-time estimate of this prompt's reusable KV tokens: the
        resident G1 prefix (a non-mutating peek: pricing touches no refcount
        nor LRU order) extended by the tiers' membership probe (the port's
        tiers are local, so the JAX build's ``local_only`` is implied).
        Capped at len-1: the final token always computes."""
        if not self.config.enable_prefix_caching:
            return 0
        hashes = seq.block_seq.block_hashes
        m = self.allocator.peek_prefix(hashes)
        t = self.block_manager.probe_prefix(hashes, m) if self.block_manager is not None else 0
        return max(0, min((m + t) * self.config.page_size, len(seq.tokens) - 1))

    # -- speculative decoding ----------------------------------------------

    def _spec_active(self) -> bool:
        """Speculation runs only with a proposer AND a runner that has the
        verify dispatch (spec_k is inert otherwise)."""
        return self.config.spec_k > 0 and self._proposer is not None and hasattr(self.runner, "spec_step")

    def _propose_drafts(self, decode_rows: list[Sequence], chunks: list[tuple[Sequence, int]]) -> list[list[int]]:
        """Per decode row, up to spec_k draft tokens for this step's verify
        (``dynamo_tpu/engine/core.py:_propose_drafts``).

        Drafts are charged against the mixed step's chunk budget (whatever
        the scheduled chunks left of it): a draft token costs a forward's
        work like a prefill-chunk token. Page extension is opportunistic: on
        exhaustion the row's drafts are dropped rather than preempting
        anyone. Rows with repetition penalties never draft: they sample from
        a history that grows per accepted token, which the per-column verify
        sample cannot replay; nor do constrained rows (their machine advances
        per accepted token)."""
        k = self.config.spec_k
        budget = None
        chunk_budget = self.chunk_budget_tokens()
        if chunk_budget > 0:
            budget = max(0, min(chunk_budget, self.config.max_prefill_tokens) - sum(n for _, n in chunks))
        drafts: list[list[int]] = []
        for s in decode_rows:
            # remaining - 1: the verify step emits at most len(draft) + 1
            # tokens, which must never overrun max_tokens or the context
            # window (this also keeps every speculative KV write inside the
            # row's position limit). Effective state: a chained row's
            # in-flight token already counts against the budget.
            dc, de = self._adv(s)
            cap = min(k, self._eff_remaining(s) - 1)
            if budget is not None:
                cap = min(cap, budget)
            sp = s.request.sampling
            if cap <= 0 or sp.frequency_penalty or sp.presence_penalty or s.constraint is not None:
                drafts.append([])
                continue
            # A chained row (de=1) has a host context one token short: propose
            # one more and drop the head, which guesses the in-flight token.
            d = [int(tok) for tok in self._proposer.propose(s.tokens, cap + de)][de:]
            if d:
                need = s.pages_needed(self.config.page_size, dc + 1 + len(d))
                if need:
                    try:
                        s.pages.extend(self.allocator.allocate(need))
                    except OutOfPagesError:
                        d = []
            if budget is not None:
                budget -= len(d)
            self.spec_tokens_proposed += len(d)
            drafts.append(d)
        return drafts

    def _lp_cols(self, seq: Sequence, lp_aux, i: int, toks: list[int]) -> list[dict] | None:
        """Logprobs entries from a verify's per-column aux arrays ([B, V] /
        [B, V, k]): one entry per emitted token, column j of row i. Chunk
        rows pass a single token (their column 0)."""
        enc = seq.request.sampling.logprobs
        if not enc or lp_aux is None:
            return None
        alts = min(enc - 1, lp_aux["top_ids"].shape[-1])
        entries = []
        for j, tok in enumerate(toks):
            top = [[int(t), float(lp)] for t, lp in zip(lp_aux["top_ids"][i, j][:alts], lp_aux["top_lps"][i, j][:alts])]
            entries.append({"id": int(tok), "logprob": float(lp_aux["logprob"][i, j]), "top": top})
        return entries

    def _compose(self, batch: list[Sequence], ns: list[int], n_dec: int, drafts: list[list[int]],
                 chain: bool) -> tuple:
        """Host arrays of a (possibly mixed, possibly verify) dispatch, each
        row at its effective state: a decode row's span is its input token
        (taken on the device when ``chain`` and the row chains) and its
        drafts; a chunk row's its next prompt tokens. Returns ``(tokens,
        positions, block_tables, slots, last, chain_src, samples)``."""
        ps = self.config.page_size
        t = max(ns)
        b = len(batch)
        npg = max(len(s.pages) for s in batch)
        tokens = np.zeros((b, t), np.int32)
        positions = np.zeros((b, t), np.int32)
        block_tables = np.zeros((b, npg), np.int32)
        slots = np.zeros((b, t), np.int32)
        last = np.zeros(b, np.int32)
        chain_src = np.full(b, -1, np.int32)
        samples = [False] * b
        for i, (s, n) in enumerate(zip(batch, ns)):
            ec = self._eff_cached(s)
            if i < n_dec:
                src = self._chain_map.get(s.seq_id, -1) if chain else -1
                if src >= 0:
                    chain_src[i] = src  # column 0 taken on the device
                else:
                    # The host knows the input token (nothing in flight for
                    # this row; an IndexError here would mean the chain map
                    # lost an in-flight row, never silence it).
                    tokens[i, 0] = s.tokens[ec]
                # Drafts are not in s.tokens: they join the sequence (and its
                # hash chain) only if the verify accepts them.
                tokens[i, 1:n] = drafts[i]
                samples[i] = True
            else:
                tokens[i, :n] = s.tokens[ec:ec + n]
                samples[i] = ec + n == len(s.tokens)
            pos = np.arange(ec, ec + n, dtype=np.int32)
            positions[i, :n] = pos
            block_tables[i, : len(s.pages)] = s.pages
            page_arr = np.asarray(s.pages, dtype=np.int32)
            slots[i, :n] = page_arr[pos // ps] * ps + pos % ps
            last[i] = n - 1
        return tokens, positions, block_tables, slots, last, chain_src, samples

    def _run_mixed(self, chunks: list[tuple[Sequence, int]]) -> list[tuple[Sequence, EngineOutput]]:
        """One fused dispatch: a 1-token decode row per running sequence plus
        an n-token prefill row per scheduled chunk. Non-final chunk rows
        discard their sample — their rng counter (``num_generated``) does
        not advance, so the final chunk samples exactly what a whole-prompt
        prefill would. With speculation on, the decode rows carry their
        drafts and the step is a verify dispatch."""
        fused = self.config.chunk_prefill_tokens > 0
        spec = self._spec_active()
        out: list[tuple[Sequence, EngineOutput]] = []
        decode_rows: list[Sequence] = []
        if (fused or (spec and not chunks)) and self.running:
            failed = self._ensure_burst_pages(1)
            if failed is not None:
                out.append((failed, self._final_output(failed)))
            decode_rows = list(self.running)
        # After _ensure_burst_pages: its preemptions change the row list. A
        # verify carries no mask: a batch with a constrained row runs a plain
        # step (drafts dropped, losslessly).
        spec = spec and not self._any_constrained(decode_rows, chunks)
        drafts = self._propose_drafts(decode_rows, chunks) if spec and decode_rows else [[] for _ in decode_rows]
        use_spec = spec and bool(decode_rows)
        self.last_step_info = {
            "decode_rows": len(decode_rows),
            "chunk_rows": len(chunks),
            "chunk_tokens": int(sum(n for _, n in chunks)),
            "decodable": len(self.running),
        }
        if chunks and fused:
            self.mixed_steps += 1
        if chunks and self.running and not decode_rows:
            self.stall_violations += 1  # legacy XOR: this dispatch stalls decodes
        batch = decode_rows + [s for s, _ in chunks]
        if not batch:
            return out
        n_dec = len(decode_rows)
        ns = [1 + len(d) for d in drafts] + [n for _, n in chunks]
        # A row samples iff its span reaches the end of its tokens: all
        # decode rows, and exactly the chunks that finish their prompt.
        tokens, positions, block_tables, slots, last, _, samples = self._compose(batch, ns, n_dec, drafts, False)
        sb = self._sampling_batch(batch, tokens, positions, block_tables, slots, last)
        sb.logit_mask = self._constraint_masks(batch)
        lp_k = LOGPROBS_TOP_K if any(
            s.request.sampling.logprobs and smp for s, smp in zip(batch, samples)
        ) else 0
        v = self.config.spec_k + 1
        targets = None
        try:
            if use_spec:
                # Decode rows score every column, chunk rows only their last
                # (start n-1): chunk sampling stays the non-speculative step's.
                sb.spec_start = np.asarray([0] * n_dec + [n - 1 for _, n in chunks], np.int32)
                stepped = self.runner.spec_step(sb, v, lp_k=lp_k) if lp_k else self.runner.spec_step(sb, v)
                targets, lp_aux = stepped if lp_k else (stepped, None)
                next_tokens = targets[:, 0]
            else:
                stepped = self.runner.step(sb, lp_k=lp_k) if lp_k else self.runner.step(sb)
                next_tokens, lp_aux = stepped if lp_k else (stepped, None)
        except Exception:
            for s in batch:
                self._finish(s, FinishReason.ERROR)
            raise
        rec = _InflightStep(batch, None, ns=ns, n_dec=n_dec, samples=samples, kind="spec" if use_spec else "step",
                            drafts=drafts, v=v if use_spec else 1)
        return out + self._apply_mixed_results(rec, next_tokens, lp_aux, targets)

    def _apply_mixed_results(self, rec: _InflightStep, next_tokens, lp_aux, targets=None, *,
                             chain_out: bool = False) -> list[tuple[Sequence, EngineOutput]]:
        """Apply a (possibly mixed, possibly speculative) step's sampled
        tokens; shared by the synchronous path and the overlapped harvest.
        Rows whose sequence left RUNNING while the step was in flight
        (cancelled, preempted, finished by a late stop) are skipped: their
        samples are discarded. A verify row accepts the longest draft prefix
        its targets replay, plus the bonus token after it. With
        ``chain_out`` (a verify's harvest) each surviving row's last
        accepted token is recorded in ``_chain_map`` as its index in the
        runner's flat ``[B*V]`` targets, for the next dispatch to chain."""
        batch, ns, samples = rec.batch, rec.ns, rec.samples
        use_spec = rec.kind == "spec"
        ps = self.config.page_size
        out: list[tuple[Sequence, EngineOutput]] = []
        spec_accepted = 0
        for i, (s, n) in enumerate(zip(batch, ns)):
            if s.status is not SeqStatus.RUNNING:
                self._chain_map.pop(s.seq_id, None)
                continue
            if use_spec and i < rec.n_dec:
                # targets[i, j] is the token the non-speculative engine would
                # sample after j accepted tokens (fold counter num_generated
                # + j), so once targets[i, j] != draft[j] the later columns
                # were scored on a context the real stream never reaches.
                draft = rec.drafts[i]
                emitted = [int(next_tokens[i])]
                while len(emitted) <= len(draft) and emitted[-1] == draft[len(emitted) - 1]:
                    emitted.append(int(targets[i, len(emitted)]))
                accepted: list[int] = []
                for tok in emitted:
                    s.num_cached += 1
                    s.append_token(tok)
                    self._generated_tokens_total += 1
                    accepted.append(tok)
                    if s.check_stop(self._eos, self.config.max_seq_len) is not None:
                        break  # overshoot past EOS or the length limit is discarded
                spec_accepted += max(0, len(accepted) - 1)
                if chain_out and not s.is_finished:
                    self._chain_map[s.seq_id] = i * rec.v + len(accepted) - 1
                # Roll back speculative pages the accepted span did not reach:
                # freshly allocated this step (commit never passes num_cached).
                if not s.is_finished:
                    keep = s.num_cached // ps + 1
                    if len(s.pages) > keep:
                        extra = [p for p in s.pages[keep:] if p != 0]
                        del s.pages[keep:]
                        if extra:
                            self.allocator.release(extra)
                self._commit_filled_pages(s)
                self._accept_constrained(s, accepted)  # may finish the row: after the commit
                out.append(self._emit_many(s, accepted, self._lp_cols(s, lp_aux, i, accepted)))
                continue
            # Prompt-token accounting: only the prompt part of the span.
            self._prompt_tokens_total += max(0, min(s.num_cached + n, s.num_prompt) - s.num_cached)
            s.num_cached += n
            if n > 1 or not samples[i]:
                s.prefill_chunks += 1
            if samples[i]:
                tok = int(next_tokens[i])
                s.append_token(tok)
                self._generated_tokens_total += 1
                self._commit_filled_pages(s)
                self._accept_constrained(s, [tok])  # may finish the row: after the commit
                if chain_out and not s.is_finished:
                    self._chain_map[s.seq_id] = i * rec.v  # its column 0
                lp = self._lp_cols(s, lp_aux, i, [tok]) if use_spec else self._lp_entries(s, lp_aux, i)
                out.append(self._emit(s, tok, lp))
            else:
                # Non-final chunk: publish its full pages (shareable before
                # the prefill finishes) and discard the sampled token.
                self._commit_filled_pages(s)
        if use_spec:
            drafted = sum(len(d) for d in rec.drafts)
            self.spec_steps += 1
            self.spec_tokens_accepted += spec_accepted
            self.last_step_info["spec_drafted"] = drafted
            self.last_step_info["spec_accepted"] = spec_accepted
            self.last_step_info["spec_accept_rate"] = round(spec_accepted / drafted, 4) if drafted else 0.0
        # Chunks whose final span sampled are decodable now.
        for s in batch[rec.n_dec:]:
            if s in self.prefilling and s.prompt_remaining <= 1 and not s.is_finished:
                self.prefilling.remove(s)
                self.running.append(s)
        return out

    # -- overlapped mixed pipeline -----------------------------------------

    def _ensure_lookahead_pages(self, rows: list[Sequence], horizon: int = 1) -> Sequence | None:
        """Give every lookahead decode row pages covering its chained writes
        (positions ``eff_cached .. eff_cached + horizon - 1``, clamped to the
        row's finish line; horizon > 1 is a decode_steps burst); preempt on
        exhaustion. Rows preempted by an earlier row's allocation are dropped
        from ``rows`` in place (the caller filters again for victims already
        behind the cursor). A sole row that cannot fit is returned
        *unfinished*: the step in flight may hold its legitimate finish."""
        ps = self.config.page_size
        i = 0
        while i < len(rows):
            s = rows[i]
            if s.status is not SeqStatus.RUNNING:
                rows.pop(i)
                continue
            need = s.pages_needed(ps, self._adv(s)[0] + max(1, min(horizon, self._eff_remaining(s))))
            if need:
                try:
                    s.pages.extend(self.allocator.allocate(need))
                except OutOfPagesError:
                    victim = self.running[-1] if self.running else s
                    if victim is s and len(self.running) <= 1:
                        return s
                    self._preempt(victim)
                    continue  # retry same index (rows may shrink behind us)
            i += 1
        return None

    def _abort_pipeline(self, batch: list[Sequence]) -> None:
        """A dispatch crashed mid-pipeline: fail its rows AND those still in
        flight (rows finishing inside the in-flight step live only there),
        then reset the chain state so a recovering caller starts from a
        clean pipeline. ``_finish`` releases each sequence's pages once."""
        failed: dict[int, Sequence] = {id(s): s for s in batch}
        if self._inflight is not None:
            self._aborted_inflight = len(self._inflight.batch)
            for s in self._inflight.batch:
                failed.setdefault(id(s), s)
            self._inflight = None
        self._inflight_adv = {}
        self._chain_map = {}
        if hasattr(self.runner, "reset_chain"):
            self.runner.reset_chain()
        for s in failed.values():
            if s.status is not SeqStatus.FINISHED:
                self._finish(s, FinishReason.ERROR)

    def _run_mixed_overlapped(self, chunks: list[tuple[Sequence, int]]) -> list[tuple[Sequence, EngineOutput]]:
        """Depth-1 overlapped pipeline over mixed steps
        (``dynamo_tpu/engine/core.py:_run_mixed_overlapped``, less its
        multimodal branches).

        Step N+1 is composed at the sequences' effective state
        (``_inflight_adv``) and dispatched before step N's tokens reach the
        host. Decode rows whose input token is still in flight take it on
        the device from step N's samples (``_chain_map``); prefill chunk
        rows feed from the host (their tokens are known). Penalty history is
        restored on the device for chained rows and the position-limit clamp
        keeps a budget-final row's write off live pages, so neither needs a
        barrier. Rows that finish *inside* the in-flight step are left out
        of the lookahead: their finish is detected at harvest, one step
        late, and streams stay bit-identical to overlap=False.

        With speculation on, the step in flight was harvested before this
        one was scheduled (``_step_locked``), so the step is composed as the
        synchronous engine composes it: every decode row drafts from its
        whole context and the dispatch is a verify (``spec_step_async``)
        whose accepted columns the next step chains from. ``decode_steps >
        1`` issues the burst's K-1 further pure-decode steps chained behind
        the dispatch, harvested with it one step late."""
        fused = self.config.chunk_prefill_tokens > 0
        out: list[tuple[Sequence, EngineOutput]] = []
        info = self.last_step_info = {
            "decode_rows": 0,
            "chunk_rows": len(chunks),
            "chunk_tokens": int(sum(n for _, n in chunks)),
            "decodable": len(self.running),
            "chained_rows": 0,
        }
        inf = self._inflight
        # Decode candidates at effective state: running rows still short of
        # their finish line, plus mid-prompt rows that decode once the
        # in-flight step lands (_decodes_next; a sampling final chunk's
        # sample is taken on the device).
        decode_rows = [
            s for s in self.running
            if s.status is SeqStatus.RUNNING and self._eff_remaining(s) >= 1
        ] + [
            s for s in self.prefilling
            if self._decodes_next(s) and self._eff_remaining(s) >= 1
        ]
        if not decode_rows and not chunks:
            # Everything live finishes inside the in-flight step (or the
            # schedule is page-starved): commit it, refill next step.
            if inf is not None:
                self._note_barrier("drain")
                out += self._drain_inflight()
            return out
        # A verify carries no mask: a batch with a constrained row runs a
        # plain chained step (drafts dropped, losslessly).
        spec = self._spec_active() and not self._any_constrained(decode_rows, chunks)
        # decode_steps > 1: only clean decode batches burst (chunks change
        # the composition mid-burst, speculation already amortizes the round
        # trip, a constraint needs a fresh mask per token, logprobs and
        # penalty history need the host between tokens).
        k_cfg = max(1, self.config.decode_steps)
        want_burst = k_cfg > 1 and not chunks and not spec and bool(decode_rows) and not any(
            s.constraint is not None or s.request.sampling.logprobs or s.request.sampling.frequency_penalty
            or s.request.sampling.presence_penalty for s in decode_rows)
        failed = self._ensure_lookahead_pages(decode_rows, k_cfg if want_burst else 1)
        if failed is not None and want_burst:
            # The burst's horizon did not fit; one lookahead token still might.
            want_burst = False
            failed = self._ensure_lookahead_pages(decode_rows, 1)
        if failed is not None:
            # The sole candidate cannot extend: the in-flight step may hold
            # its legitimate finish. Commit that first, then check again.
            self._note_barrier("pages")
            out += self._drain_inflight()
            if failed.status is SeqStatus.RUNNING:
                f2 = self._ensure_burst_pages(1)
                if f2 is not None:
                    out.append((f2, self._final_output(f2)))
            return out
        # _ensure_lookahead_pages may have preempted rows already behind its
        # cursor; drop them (their recompute is scheduled from waiting).
        decode_rows = [s for s in decode_rows if s.status is SeqStatus.RUNNING]
        k_burst = 1
        if want_burst and decode_rows:
            # Never burst a row past its finish line: every sub-step is a real
            # dispatch, so the shortest row clamps the depth.
            k_burst = max(1, min(k_cfg, min(self._eff_remaining(s) for s in decode_rows)))
        drafts = self._propose_drafts(decode_rows, chunks) if spec and decode_rows else [[] for _ in decode_rows]
        use_spec = spec and bool(decode_rows)
        batch = decode_rows + [s for s, _ in chunks]
        if not batch:
            if inf is not None:
                self._note_barrier("drain")
                out += self._drain_inflight()
            return out
        n_dec = len(decode_rows)
        info["decode_rows"] = n_dec
        if chunks and fused:
            self.mixed_steps += 1
        ns = [1 + len(d) for d in drafts] + [n for _, n in chunks]
        tokens, positions, block_tables, slots, last, chain_src, samples = self._compose(
            batch, ns, n_dec, drafts, True)
        b = len(batch)
        chained = int((chain_src >= 0).sum())
        info["chained_rows"] = chained + b * (k_burst - 1)  # every sub-step row chains
        sb = self._sampling_batch(batch, tokens, positions, block_tables, slots, last)
        if any(s.constraint is not None for s in batch):
            if chained:
                # Masks resolve on the device against the chained token.
                self._attach_lookahead_masks(sb, batch)
            else:
                # Pipeline fill: every input token is on the host.
                sb.logit_mask = self._constraint_masks(batch)
        lp_k = LOGPROBS_TOP_K if any(
            s.request.sampling.logprobs and smp for s, smp in zip(batch, samples)
        ) else 0
        v = self.config.spec_k + 1
        ps = self.config.page_size
        try:
            if use_spec:
                sb.spec_start = np.asarray([0] * n_dec + [n - 1 for _, n in chunks], np.int32)
                dev = self.runner.spec_step_async(sb, v, lp_k=lp_k, chain_src=chain_src if chained else None)
                new_inf = _InflightStep(batch, dev, ns=ns, n_dec=n_dec, samples=samples, kind="spec",
                                        drafts=drafts, v=v)
            else:
                dev = self.runner.step_async(sb, lp_k=lp_k, chain=chained > 0,
                                             chain_src=chain_src if chained else None)
                new_inf = _InflightStep(batch, dev, ns=ns, n_dec=n_dec, samples=samples, drafts=drafts)
                for j in range(1, k_burst):
                    # Burst sub-step j: row i's input is the previous
                    # dispatch's row-i sample (the identity chain); positions
                    # and slots advance by j, and sample_steps by j keeps the
                    # fold counter on the synchronous loop's lattice.
                    pos_j = positions[:, :1] + j
                    slots_j = np.zeros((b, 1), np.int32)
                    for i, s in enumerate(batch):
                        p = int(pos_j[i, 0])
                        slots_j[i, 0] = s.pages[p // ps] * ps + p % ps
                    sbj = self._sampling_batch(batch, np.zeros((b, 1), np.int32), pos_j, block_tables, slots_j,
                                               np.zeros(b, np.int32))
                    sbj.sample_steps += j
                    new_inf.extra.append(self.runner.step_async(sbj, chain=True, chain_src=None))
        except Exception:
            self._abort_pipeline(batch)
            raise
        if inf is not None:
            self._overlap_mode = "overlapped"
        else:
            self._note_barrier("fill")
        # The new dispatch's chain map: a verify's is known only at its
        # harvest (acceptance decides the column); a step's is its emitting
        # rows. Installed *before* the harvest below so late finishes prune
        # their entries.
        self._chain_map = {} if use_spec else {
            s.seq_id: i for i, (s, smp) in enumerate(zip(batch, samples)) if smp}
        if inf is not None:
            out += self._harvest_inflight()
        self._inflight = new_inf
        if use_spec:
            # A verify row advances by 1..k+1 tokens, unknown until harvest
            # (so the next step harvests first); only the chunk rows'
            # advance is certain.
            self._inflight_adv = {s.seq_id: (n, 1 if smp else 0)
                                  for s, n, smp in zip(batch[n_dec:], ns[n_dec:], samples[n_dec:])}
        else:
            # A burst's sub-steps advance every row one more slot and one
            # more token each (a row finishing mid-burst discards the
            # overshoot at harvest).
            self._inflight_adv = {s.seq_id: (n + k_burst - 1, (1 if smp else 0) + k_burst - 1)
                                  for s, n, smp in zip(batch, ns, samples)}
        return out

    def _harvest_inflight(self) -> list[tuple[Sequence, EngineOutput]]:
        """Consume the in-flight step (waiting for its tokens) and apply it;
        the device-resident samples stay valid for a dispatch composed on
        top (a verify's: its accepted columns, ``chain_out``). Clears the
        effective-state advance: the host has caught up."""
        inf = self._inflight
        if inf is None:
            return []
        self._inflight = None
        self._inflight_adv = {}
        res, lp_aux = inf.handle.result()
        if inf.kind == "spec":
            return self._apply_mixed_results(inf, res[:, 0], lp_aux, res, chain_out=True)
        out = self._apply_mixed_results(inf, res[:, 0], lp_aux)
        for h in inf.extra:
            # Burst sub-steps: one more pure-decode token a row each, in
            # dispatch order. Rows finished by an earlier sub-step are
            # skipped (the RUNNING check); their overshoot writes land in
            # pages reallocated only to dispatches composed after these.
            res_j, lp_j = h.result()
            b = len(inf.batch)
            rec = _InflightStep(inf.batch, h, ns=[1] * b, n_dec=b, samples=[True] * b)
            out += self._apply_mixed_results(rec, res_j[:, 0], lp_j)
        return out

    def _drain_inflight(self) -> list[tuple[Sequence, EngineOutput]]:
        """Consume the in-flight step without composing on top of it: apply
        its results, then reset the chain state (nothing chains from the
        device buffer until the pipeline refills)."""
        out = self._harvest_inflight()
        self._chain_map = {}
        if hasattr(self.runner, "reset_chain"):
            self.runner.reset_chain()
        return out

    # -- decode phase ------------------------------------------------------

    def _run_decode(self) -> list[tuple[Sequence, EngineOutput]]:
        """A synchronous pure-decode step, or a fused burst of up to
        ``decode_steps`` (never past the farthest finish line: a power of
        two keeps the burst on few dispatch keys; logprobs take single
        steps, the burst surfaces no per-step logits)."""
        k = max(1, self.config.decode_steps)
        if self.running:
            rem = max(s.remaining_tokens(self.config.max_seq_len) for s in self.running)
            k = max(1, min(k, next_pow2(rem)))
        if any(s.request.sampling.logprobs or s.constraint is not None for s in self.running):
            k = 1  # logprobs and masks take single steps
        failed = self._ensure_burst_pages(k)
        if failed is not None:
            return [(failed, self._final_output(failed))]
        batch = list(self.running)  # snapshot: _emit may finish rows
        if not batch:
            return []
        ps = self.config.page_size
        b = len(batch)
        n = max(len(s.pages) for s in batch)
        tokens = np.zeros((b, 1), np.int32)
        positions = np.zeros((b, 1), np.int32)
        block_tables = np.zeros((b, n), np.int32)
        slots = np.zeros((b, 1), np.int32)
        for i, s in enumerate(batch):
            pos = s.num_cached
            tokens[i, 0] = s.tokens[pos]
            positions[i, 0] = pos
            block_tables[i, : len(s.pages)] = s.pages
            slots[i, 0] = s.pages[pos // ps] * ps + pos % ps
        sb = self._sampling_batch(batch, tokens, positions, block_tables, slots, np.zeros(b, np.int32))
        if k == 1:
            sb.logit_mask = self._constraint_masks(batch)
        lp_k = LOGPROBS_TOP_K if any(s.request.sampling.logprobs for s in batch) else 0
        lp_aux = None
        try:
            if k > 1:
                next_tokens = self.runner.multi_step(sb, k)  # [B, k]
            else:
                stepped = self.runner.step(sb, lp_k=lp_k) if lp_k else self.runner.step(sb)
                stepped, lp_aux = stepped if lp_k else (stepped, None)
                next_tokens = np.asarray(stepped)[:, None]
        except Exception:
            for s in batch:
                self._finish(s, FinishReason.ERROR)
            raise
        outputs = []
        for i, s in enumerate(batch):
            if s.status is not SeqStatus.RUNNING:
                continue
            accepted: list[int] = []
            for tok in next_tokens[i]:
                s.num_cached += 1
                s.append_token(int(tok))
                self._generated_tokens_total += 1
                accepted.append(int(tok))
                if s.check_stop(self._eos, self.config.max_seq_len) is not None:
                    break  # the burst's overshoot is discarded
            self._commit_filled_pages(s)
            self._accept_constrained(s, accepted)  # may finish the row: after the commit
            outputs.append(self._emit_many(s, accepted, self._lp_entries(s, lp_aux, i)))
        return outputs

    def _ensure_burst_pages(self, horizon: int) -> Sequence | None:
        """Give every running sequence pages covering its next ``horizon``
        tokens; preempt on exhaustion. A sole sequence that cannot fit is
        finished with ERROR and returned."""
        i = 0
        while i < len(self.running):
            seq = self.running[i]
            remaining = seq.remaining_tokens(self.config.max_seq_len)
            need = seq.pages_needed(self.config.page_size, min(horizon, remaining))
            if need:
                try:
                    seq.pages.extend(self.allocator.allocate(need))
                except OutOfPagesError:
                    victim = self.running[-1]
                    if victim is seq and len(self.running) == 1:
                        self._finish(seq, FinishReason.ERROR)  # context outgrew the cache
                        return seq
                    self._preempt(victim)
                    continue  # retry same index (list shrank behind us)
            i += 1
        return None

    # -- shared helpers ----------------------------------------------------

    def _sampling_batch(self, batch, tokens, positions, block_tables, slots, last) -> StepBatch:
        b = len(batch)
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        seeds = np.zeros(b, np.uint32)
        steps = np.zeros(b, np.int32)
        freq = np.zeros(b, np.float32)
        pres = np.zeros(b, np.float32)
        limits = np.zeros(b, np.int32)
        for i, s in enumerate(batch):
            sp = s.request.sampling
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seeds[i] = np.uint32((sp.seed if sp.seed is not None else s.seq_id * 0x9E3779B9 + 1) & 0xFFFFFFFF)
            # Effective rng counter: a chained row's in-flight token has
            # already taken counter num_generated (its history entry is
            # restored on the device); without a step in flight this is
            # num_generated.
            steps[i] = s.num_generated + self._adv(s)[1]
            freq[i] = sp.frequency_penalty
            pres[i] = sp.presence_penalty
            limits[i] = s.position_limit(self.config.max_seq_len)
        # Generated-token history feeds the repetition penalties; shipped
        # only when some request set one (H collapses to 1 otherwise). Its
        # width covers a fused decode burst's own samples (written in-graph).
        if freq.any() or pres.any():
            h = max(int(steps.max()) + self.config.decode_steps, 1)
            history = np.full((b, h), -1, np.int32)
            for i, s in enumerate(batch):
                gen = s.tokens[s.num_prompt:]
                history[i, : len(gen)] = gen
        else:
            history = np.full((b, 1), -1, np.int32)
        return StepBatch(tokens, positions, block_tables, slots, last, temp, top_k, top_p,
                         seeds, steps, freq, pres, limits, history)

    def _any_constrained(self, decode_rows: list[Sequence], chunks: list[tuple[Sequence, int]]) -> bool:
        return any(s.constraint is not None for s in decode_rows) or any(
            s.constraint is not None for s, _ in chunks)

    def _commit_filled_pages(self, seq: Sequence) -> None:
        """Publish newly-filled pages to the prefix cache (emits stored events)
        and queue them for write-through to the capacity tiers."""
        if not self.config.enable_prefix_caching:
            return
        full_pages = seq.num_cached // self.config.page_size
        blocks = seq.block_seq.blocks
        while seq.committed_pages < full_pages:
            idx = seq.committed_pages
            blk = blocks[idx]
            newly_cached = self.allocator.commit(seq.pages[idx], blk.block_hash, blk.parent_hash, blk.tokens)
            if newly_cached and self.block_manager is not None:
                # Read in flush_offloads, batched, after the step's outputs.
                self.pending_offloads.append((blk.block_hash, seq.pages[idx]))
            seq.committed_pages += 1

    def flush_offloads(self) -> None:
        """Write the pending committed pages through to the capacity tiers
        with one batched page read (``runner.read_pages_async``): between
        steps, under step_lock, so the pages are still live."""
        with self.step_lock:
            if self.block_manager is None or not self.pending_offloads:
                self.pending_offloads = []
                return
            items, self.pending_offloads = self.pending_offloads, []
            self.block_manager.offload_batch(
                items,
                read_pages=getattr(self.runner, "read_pages", None),
                read_pages_async=getattr(self.runner, "read_pages_async", None),
            )

    def abort_all(self, reason: FinishReason = FinishReason.ERROR) -> None:
        """Finish every live sequence (releasing its pages) and drop the step
        in flight; blocks until a step running in another thread completes."""
        with self.step_lock:
            self._inflight = None
            self._inflight_adv = {}
            self._chain_map = {}
            self._onboards = []  # orphaned fetch threads write into dropped sessions
            if hasattr(self.runner, "reset_chain"):
                self.runner.reset_chain()
            for seq in list(self.running) + list(self.prefilling) + list(self.waiting):
                seq.context.kill()
                self._finish(seq, reason)
            self.pending_offloads = []

    def _emit(self, seq: Sequence, token: int, logprobs: list[dict] | None = None) -> tuple[Sequence, EngineOutput]:
        reason = seq.check_stop(self._eos, self.config.max_seq_len)
        if reason is not None and not seq.is_finished:
            self._finish(seq, reason)
        # First delta for this sequence: attach the admission wait (the
        # frontend observes it once) and close the predictor's loop with the
        # actual TTFT.
        wait_ms = None
        if seq.admitted_time is not None and not seq.admission_reported:
            seq.admission_reported = True
            wait_ms = max(0.0, (seq.admitted_time - seq.arrival_time) * 1e3)
            if self.admission is not None:
                self.admission.on_first_token(seq, time.monotonic())
        return seq, EngineOutput(
            token_ids=[token],
            finish_reason=seq.finish_reason,
            cumulative_tokens=seq.num_generated,
            prompt_tokens=seq.num_prompt if seq.finish_reason else None,
            cached_tokens=seq.num_cached_at_start if seq.finish_reason else None,
            logprobs=logprobs[:1] if logprobs else None,
            admission_wait_ms=round(wait_ms, 3) if wait_ms is not None else None,
        )

    def _emit_many(self, seq: Sequence, tokens: list[int], logprobs: list[dict] | None = None
                   ) -> tuple[Sequence, EngineOutput]:
        """One delta of several tokens (a verify's accepted span, a burst)."""
        seq_out = self._emit(seq, tokens[-1], logprobs)
        out = seq_out[1]
        out.token_ids = list(tokens)
        out.logprobs = logprobs[:len(tokens)] if logprobs else None
        return seq_out

    def _lp_entries(self, seq: Sequence, lp_aux, i: int) -> list[dict] | None:
        """One request's logprobs entry from a step's aux arrays (row i)."""
        enc = seq.request.sampling.logprobs
        if not enc or lp_aux is None:
            return None
        alts = min(enc - 1, lp_aux["top_ids"].shape[1])
        top = [
            [int(t), float(lp)]
            for t, lp in zip(lp_aux["top_ids"][i][:alts], lp_aux["top_lps"][i][:alts])
        ]
        return [{"id": int(seq.tokens[-1]), "logprob": float(lp_aux["logprob"][i]), "top": top}]

    def _final_output(self, seq: Sequence) -> EngineOutput:
        return EngineOutput(
            token_ids=[],
            finish_reason=seq.finish_reason,
            cumulative_tokens=seq.num_generated,
            prompt_tokens=seq.num_prompt,
            cached_tokens=seq.num_cached_at_start,
        )

    def _preempt(self, seq: Sequence) -> None:
        logger.info("preempting seq %d (%d pages)", seq.seq_id, len(seq.pages))
        self.num_preemptions += 1
        self._cancel_onboards(seq)
        self.allocator.release([p for p in seq.pages if p != 0])
        seq.pages = []
        seq.committed_pages = 0
        seq.num_cached = 0
        seq.prefill_chunks = 0
        seq.status = SeqStatus.PREEMPTED
        # Any in-flight advance is void: on re-admission the sequence
        # restarts from num_cached=0.
        self._inflight_adv.pop(seq.seq_id, None)
        self._chain_map.pop(seq.seq_id, None)
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.prefilling:
            self.prefilling.remove(seq)
        self.waiting.appendleft(seq)

    def _finish(self, seq: Sequence, reason: FinishReason) -> None:
        seq.status = SeqStatus.FINISHED
        seq.finish_reason = reason
        self._cancel_onboards(seq)
        if self.admission is not None:
            self.admission.on_finish(seq)
        if seq.pages:
            self.allocator.release([p for p in seq.pages if p != 0])
            seq.pages = []
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.prefilling:
            self.prefilling.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)

    # -- bookkeeping -------------------------------------------------------

    def metrics(self) -> ForwardPassMetrics:
        st = self.allocator.stats()
        return ForwardPassMetrics(
            worker_id=self.config.worker_id,
            kv_active_blocks=st.active_pages,
            kv_total_blocks=st.total_pages,
            num_requests_waiting=len(self.waiting),
            num_requests_running=len(self.running) + len(self.prefilling),
            request_total_slots=self.config.max_batch_size,
            cache_hit_rate=st.hit_rate,
            prompt_tokens_total=self._prompt_tokens_total,
            generated_tokens_total=self._generated_tokens_total,
        )
