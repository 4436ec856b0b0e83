"""Frontend Prometheus metrics (a copy of ``dynamo_tpu/frontend/metrics.py``
less its SLO plane; the families it keeps have the JAX build's names, help
texts, labels and buckets).

Three levels, mirroring the reference (`http/service/metrics.rs:28-110`):
per-request counters/durations, streaming quality (TTFT / inter-token
latency), and size histograms (input/output sequence length), plus the
router's per-worker load staleness, the runtime clients' watch and breaker
state and the router's index resyncs. Exposed in Prometheus text format at
GET /metrics.

Not ported yet: the SLO accountant and incident capture, with the families
synced from them (``dynamo_output_tokens_total``,
``dynamo_goodput_tokens_total``, ``dynamo_slo_*``, ``dynamo_alert_*``,
``dynamo_frontend_ttft_quantile_seconds``,
``dynamo_frontend_itl_quantile_seconds``); the worker-telemetry federation
(``dynamo_federation_scrape_failures_total``); the store and replication
families (``dynamo_store_*``), which come with the TCP runtime; and the
kernel-fallback gauge, which counts programs that fell back from a Pallas
kernel: the port has no fallback.
"""

from __future__ import annotations

import time

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram, generate_latest

from dynamo_tpu_torch.router.events import router_resync_snapshot
from dynamo_tpu_torch.runtime.client import breaker_snapshot, watch_snapshot

_DURATION_BUCKETS = (0.005, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
_QUEUE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0)
_TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 2.0, 5.0, 10.0)
_ITL_BUCKETS = (0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.1, 0.2, 0.5, 1.0)
_LEN_BUCKETS = (16, 64, 256, 1024, 3000, 8192, 32768, 131072)


class FrontendMetrics:
    def __init__(self, registry: CollectorRegistry | None = None) -> None:
        self.registry = registry or CollectorRegistry()
        ns = "dynamo_frontend"
        self.requests = Counter(
            f"{ns}_requests_total", "Requests received", ["model", "endpoint", "status"], registry=self.registry
        )
        self.inflight = Gauge(f"{ns}_inflight_requests", "Requests in flight", ["model"], registry=self.registry)
        self.duration = Histogram(
            f"{ns}_request_duration_seconds", "Request duration", ["model"],
            buckets=_DURATION_BUCKETS, registry=self.registry,
        )
        self.ttft = Histogram(
            f"{ns}_time_to_first_token_seconds", "TTFT", ["model"], buckets=_TTFT_BUCKETS, registry=self.registry
        )
        self.itl = Histogram(
            f"{ns}_inter_token_latency_seconds", "ITL", ["model"], buckets=_ITL_BUCKETS, registry=self.registry
        )
        self.input_len = Histogram(
            f"{ns}_input_sequence_tokens", "Prompt tokens", ["model"], buckets=_LEN_BUCKETS, registry=self.registry
        )
        self.output_len = Histogram(
            f"{ns}_output_sequence_tokens", "Generated tokens", ["model"], buckets=_LEN_BUCKETS, registry=self.registry
        )
        self.cached_tokens = Counter(
            f"{ns}_cached_prompt_tokens_total", "Prompt tokens served from prefix cache", ["model"],
            registry=self.registry,
        )
        # Accept -> engine-dispatch gap: frontend-side time (parse, model
        # lookup, preprocessing) before the request enters the pipeline.
        self.request_queue = Histogram(
            f"{ns}_request_queue_seconds", "Accept to engine-dispatch gap", ["model"],
            buckets=_QUEUE_BUCKETS, registry=self.registry,
        )
        # Engine-side admission wait (add_request to first scheduling) —
        # distinct from request_queue, which ends when the request *enters*
        # the pipeline; reported once per request via the first delta's
        # admission_wait_ms.
        self.admission_wait = Histogram(
            f"{ns}_admission_wait_seconds",
            "Engine admission wait (add_request to first scheduling)", ["model"],
            buckets=_QUEUE_BUCKETS, registry=self.registry,
        )
        # Router-side staleness of each worker's last load publish (synced
        # per scrape from the KvMetricsAggregator when one is wired).
        self.worker_staleness = Gauge(
            "dynamo_router_worker_staleness_seconds",
            "Seconds since the router last saw a worker's ForwardPassMetrics publish",
            ["worker"], registry=self.registry,
        )
        # Client-plane health: watch-loop restarts/staleness and per-instance
        # circuit-breaker state, synced per scrape from every live runtime
        # client in this process (runtime/client.py snapshots).
        self.client_watch_restarts = Gauge(
            "dynamo_client_watch_restarts_total",
            "Instance-watch reconnects per endpoint (a restart means the discovery watch died and was resubscribed)",
            ["endpoint"], registry=self.registry,
        )
        self.client_watch_staleness = Gauge(
            "dynamo_client_watch_staleness_seconds",
            "Seconds the endpoint's instance watch has been down (0 while healthy)",
            ["endpoint"], registry=self.registry,
        )
        self.client_breaker_state = Gauge(
            "dynamo_client_breaker_state",
            "Per-instance circuit breaker state (0 closed / 1 half-open / 2 open)",
            ["endpoint", "instance"], registry=self.registry,
        )
        self.router_index_resyncs = Gauge(
            "dynamo_router_index_resyncs_total",
            "KV-index reconstructions (snapshot rebases + gap-forced resyncs) since frontend start",
            registry=self.registry,
        )

    def render(self) -> bytes:
        # Drop label sets from a previous scrape first: an endpoint or
        # instance that left the snapshot must not keep exporting its last
        # value forever.
        self.client_watch_restarts.clear()
        self.client_watch_staleness.clear()
        self.client_breaker_state.clear()
        for path, view in watch_snapshot().items():
            self.client_watch_restarts.labels(path).set(view["restarts"])
            self.client_watch_staleness.labels(path).set(view["staleness"])
        for (path, instance), state in breaker_snapshot().items():
            self.client_breaker_state.labels(path, instance).set(state)
        self.router_index_resyncs.set(router_resync_snapshot()["resyncs"])
        return generate_latest(self.registry)

    def sync_staleness(self, staleness: dict[int, float]) -> None:
        """Refresh the per-worker staleness gauge from an aggregator view
        (clears first so departed workers drop their label sets)."""
        self.worker_staleness.clear()
        for wid, age in staleness.items():
            self.worker_staleness.labels(f"{wid:x}").set(age)

    def tracker(self, model: str, endpoint: str) -> "RequestTracker":
        return RequestTracker(self, model, endpoint)


class RequestTracker:
    """Per-request context manager: times the request + token stream gaps."""

    def __init__(self, metrics: FrontendMetrics, model: str, endpoint: str) -> None:
        self.m = metrics
        self.model = model
        self.endpoint = endpoint
        self._start = 0.0
        self._last_token: float | None = None
        self._dispatched = False
        self.status = "success"
        self._admission_reported = False

    def __enter__(self) -> "RequestTracker":
        self._start = time.monotonic()
        self.m.inflight.labels(self.model).inc()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.status = "error"
        self.m.inflight.labels(self.model).dec()
        self.m.requests.labels(self.model, self.endpoint, self.status).inc()
        self.m.duration.labels(self.model).observe(time.monotonic() - self._start)

    def on_dispatch(self) -> None:
        """The request is leaving the frontend for the engine pipeline."""
        if not self._dispatched:
            self._dispatched = True
            self.m.request_queue.labels(self.model).observe(time.monotonic() - self._start)

    def on_admission_wait(self, seconds: float) -> None:
        """Engine admission wait from the first delta (once per request)."""
        if not self._admission_reported:
            self._admission_reported = True
            self.m.admission_wait.labels(self.model).observe(max(0.0, seconds))

    def on_token(self) -> None:
        now = time.monotonic()
        if self._last_token is None:
            self.m.ttft.labels(self.model).observe(now - self._start)
        else:
            self.m.itl.labels(self.model).observe(now - self._last_token)
        self._last_token = now

    def on_usage(self, prompt_tokens: int | None, output_tokens: int, cached_tokens: int | None) -> None:
        if prompt_tokens:
            self.m.input_len.labels(self.model).observe(prompt_tokens)
        self.m.output_len.labels(self.model).observe(output_tokens)
        if cached_tokens:
            self.m.cached_tokens.labels(self.model).inc(cached_tokens)
