"""Predicted TTFT for admission control (a copy of ``dynamo_tpu/sched/predictor.py``).

The admission controller orders the waiting queue by deadline slack, which
needs a per-request TTFT estimate *before* the request runs. Two sources:

- **Profile surface** — a profiler-produced ``WorkerProfile`` interpolates
  TTFT at the current load fraction (``ttft_at``, tail percentile when the
  sweep recorded one), plus the request's own prefill service time from the
  profiled token rate. This is the same surface the SLA planner sizes with.
- **Online fallback** — with no profile loaded, the prediction is just the
  prompt's service time at an assumed prefill rate, multiplicatively
  corrected by an EWMA of observed/predicted TTFT ratios. The bias term also
  corrects a stale or wrong profile, so it always applies.

Predictions feed ordering decisions, not hard guarantees: a consistent 2x
bias shifts every slack equally and the EDF order survives it; the online
correction exists so *relative* errors across load levels shrink over time.
"""

from __future__ import annotations


class TtftPredictor:
    """Per-request TTFT estimate from a latency surface + live queue state."""

    def __init__(
        self,
        profile=None,  # dynamo_tpu_torch.planner.core.WorkerProfile | None
        *,
        prefill_tokens_per_sec: float = 20000.0,
        pct: int = 99,
        correction_alpha: float = 0.2,
    ) -> None:
        self.profile = profile
        self.pct = pct
        self._fallback_rate = max(1.0, prefill_tokens_per_sec)
        self._alpha = correction_alpha
        # Multiplicative bias: EWMA of observed_ttft / predicted_ttft,
        # clamped so one outlier can't invert the queue order.
        self._bias = 1.0
        self.observations = 0

    @property
    def bias(self) -> float:
        return self._bias

    def predict(self, *, queued_tokens: int, running: int, slots: int) -> float:
        """Seconds until first token for a request with ``queued_tokens``
        of uncomputed prompt, given ``running`` live sequences out of
        ``slots`` batch capacity."""
        load = min(1.0, running / max(slots, 1))
        if self.profile is not None:
            base = self.profile.ttft_at(load, pct=self.pct)
            rate = self.profile.prefill_tokens_per_sec or self._fallback_rate
        else:
            # No profile: queueing delay is folded into the bias term as
            # observations arrive (load shows up as larger observed/predicted
            # ratios, which inflate every later prediction).
            base = 0.0
            rate = self._fallback_rate
        service = queued_tokens / max(rate, 1.0)
        return self._bias * (base + service)

    def observe(self, predicted_s: float | None, actual_s: float) -> None:
        """Feed back an observed TTFT against the prediction made at its
        last EDF ordering (online correction)."""
        if not predicted_s or predicted_s <= 0.0 or actual_s <= 0.0:
            return
        ratio = min(8.0, max(0.125, actual_s / predicted_s))
        self._bias = min(16.0, max(0.0625, (1.0 - self._alpha) * self._bias + self._alpha * ratio))
        self.observations += 1
