"""SLO-driven chunk-budget control (a copy of ``dynamo_tpu/sched/chunk_control.py``).

The mixed-step scheduler bounds decode stalls with ``chunk_prefill_tokens``:
every prefill chunk co-dispatched with decodes costs the decode stream about
one chunk of forward time. When the live ITL tail approaches the SLO budget,
the only knob that helps *now* (without dropping work) is a smaller chunk —
prefill throughput degrades gracefully while decode latency recovers.

This controller watches the wall time of decode-carrying steps (the engine
feeds every such step) and halves/doubles the effective chunk budget with
hysteresis:

- shrink when the windowed p99 step time >= ``shrink_at`` * ITL budget,
- relax when it <= ``relax_at`` * ITL budget,
- hold otherwise (the dead band between the thresholds), and
- after any change, hold for ``cooldown_steps`` observations with a cleared
  window, so a decision is always made on post-change samples and the
  budget cannot flap between two sizes on a boundary workload.

The budget never leaves [floor_tokens, base]; it never reaches 0, so the
engine's "is chunking on" checks are unaffected.
"""

from __future__ import annotations

from collections import deque


class ChunkBudgetController:
    def __init__(
        self,
        base_tokens: int,
        itl_budget_ms: float = 50.0,
        *,
        floor_tokens: int = 64,
        shrink_at: float = 0.9,
        relax_at: float = 0.5,
        cooldown_steps: int = 8,
        window: int = 128,
        min_samples: int = 8,
    ) -> None:
        if base_tokens <= 0:
            raise ValueError("chunk controller needs chunked prefill (base_tokens > 0)")
        self.base = int(base_tokens)
        self.floor = max(1, min(int(floor_tokens), self.base))
        self.itl_budget_ms = float(itl_budget_ms)
        self.shrink_at = float(shrink_at)
        self.relax_at = float(relax_at)
        self.cooldown_steps = int(cooldown_steps)
        self.min_samples = int(min_samples)
        self.current = self.base
        self.shrinks = 0
        self.relaxes = 0
        self._gaps: deque[float] = deque(maxlen=window)
        self._cooldown = 0

    def budget(self) -> int:
        return self.current

    def tail_ms(self) -> float:
        """Windowed p99 of observed decode-step wall times (0 if empty)."""
        if not self._gaps:
            return 0.0
        s = sorted(self._gaps)
        return s[min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.999))]

    def observe(self, step_wall_ms: float) -> None:
        """Feed the wall time of one decode-carrying engine step."""
        self._gaps.append(max(0.0, float(step_wall_ms)))
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if len(self._gaps) < self.min_samples:
            return
        p99 = self.tail_ms()
        if p99 >= self.shrink_at * self.itl_budget_ms and self.current > self.floor:
            self.current = max(self.floor, self.current // 2)
            self.shrinks += 1
            self._after_change()
        elif p99 <= self.relax_at * self.itl_budget_ms and self.current < self.base:
            self.current = min(self.base, self.current * 2)
            self.relaxes += 1
            self._after_change()

    def _after_change(self) -> None:
        # Decide the next move on samples taken at the new budget only.
        self._gaps.clear()
        self._cooldown = self.cooldown_steps
