"""Planner decision logic (``dynamo_tpu/planner/core.py``): only its
:class:`WorkerProfile` so far, the profiled capacity and latency surfaces
that the SLO plane reads (``sched/__init__.py:_load_profile``, the TTFT
predictor and the router's attainment term). The planner itself (the
autoscaler over worker fleets, its load predictors and connectors) sits on
the multi-process runtime and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class WorkerProfile:
    """Per-worker capacity, from a profiler sweep (the JAX build's
    ``dynamo_tpu/profiler.py``; the port has no profiler yet).

    Latency surfaces are piecewise-linear: points of (load_fraction, seconds).
    """

    prefill_tokens_per_sec: float = 20000.0
    decode_tokens_per_sec: float = 2000.0
    max_concurrent: int = 64
    ttft_curve: list[tuple[float, float]] = field(default_factory=lambda: [(0.0, 0.05), (1.0, 0.5)])
    itl_curve: list[tuple[float, float]] = field(default_factory=lambda: [(0.0, 0.01), (1.0, 0.1)])
    # Tail-latency surfaces (p95/p99) from the same sweep. Empty by default:
    # the SLA planner keeps sizing on medians; tails are informational until
    # an SLO policy consumes them (``ttft_at(..., pct=...)``).
    ttft_p95_curve: list[tuple[float, float]] = field(default_factory=list)
    ttft_p99_curve: list[tuple[float, float]] = field(default_factory=list)
    itl_p95_curve: list[tuple[float, float]] = field(default_factory=list)
    itl_p99_curve: list[tuple[float, float]] = field(default_factory=list)

    @staticmethod
    def _interp(curve: list[tuple[float, float]], x: float) -> float:
        if not curve:
            return 0.0
        pts = sorted(curve)
        if x <= pts[0][0]:
            return pts[0][1]
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if x <= x1:
                return y0 + (y1 - y0) * (x - x0) / max(x1 - x0, 1e-9)
        return pts[-1][1]

    def ttft_at(self, load_fraction: float, *, pct: int = 50) -> float:
        curve = {95: self.ttft_p95_curve, 99: self.ttft_p99_curve}.get(pct) or self.ttft_curve
        return self._interp(curve, load_fraction)

    def itl_at(self, load_fraction: float, *, pct: int = 50) -> float:
        curve = {95: self.itl_p95_curve, 99: self.itl_p99_curve}.get(pct) or self.itl_curve
        return self._interp(curve, load_fraction)

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "WorkerProfile":
        import json

        d = json.loads(text)
        # Absent curves keep the dataclass defaults (an empty curve would
        # interpolate to 0.0 latency and blind the SLA mode).
        for key in (
            "ttft_curve", "itl_curve",
            "ttft_p95_curve", "ttft_p99_curve", "itl_p95_curve", "itl_p99_curve",
        ):
            if key in d:
                d[key] = [tuple(p) for p in d[key]]
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})
