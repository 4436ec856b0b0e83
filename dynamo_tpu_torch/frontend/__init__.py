"""OpenAI-compatible HTTP frontend (a copy of ``dynamo_tpu/frontend``).

- :mod:`dynamo_tpu_torch.frontend.openai_format` — chat/completions response
  + SSE chunk construction and stream aggregation.
- :mod:`dynamo_tpu_torch.frontend.tool_calls` — tool-call extraction and the
  streaming tool-call jail.
- :mod:`dynamo_tpu_torch.frontend.model_manager` — per-model engine registry
  and the discovery watcher that builds serving pipelines as workers appear.
- :mod:`dynamo_tpu_torch.frontend.metrics` — Prometheus request metrics
  (count/duration/TTFT/ITL/inflight, token histograms).
- :mod:`dynamo_tpu_torch.frontend.http` — the aiohttp service:
  /v1/chat/completions, /v1/completions, /v1/models, /health, /live,
  /metrics, /debug/traces/{request_id}, /clear_kv_blocks.
"""

from dynamo_tpu_torch.frontend.http import HttpService

__all__ = ["HttpService"]
