"""Model Deployment Card (MDC): everything a frontend needs to serve a model
(a copy of ``dynamo_tpu/model_card.py``; the same fields and JSON record).

Workers publish their card into the discovery store under
``models/{name}/{lease_id:x}``; the frontend's ModelWatcher builds the client
pipeline (preprocessor -> backend -> router) from it. Cards carry *specs*
(tokenizer kind or path, template text) rather than live objects so they
serialize cleanly.

Building a card from a checkpoint directory or a GGUF file comes with the
checkpoint loader, and moving its artifacts through an object store with the
TCP runtime; neither is ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

MODEL_PREFIX = "models"


@dataclass
class ModelDeploymentCard:
    name: str
    tokenizer: str = "byte"  # "byte" | path to tokenizer.json / model dir
    chat_template: str | None = None
    context_length: int = 4096
    kv_page_size: int = 16
    eos_token_ids: list[int] = field(default_factory=list)
    bos_token_id: int | None = None
    model_type: str = "chat+completions"  # which endpoints to expose
    # Endpoint the workers serve, as (namespace, component, endpoint).
    endpoint: tuple[str, str, str] = ("dynamo", "backend", "generate")
    router_mode: str = "round_robin"  # round_robin | random | kv
    extra: dict[str, Any] = field(default_factory=dict)

    def instance_key(self, lease_id: int) -> str:
        """Discovery key for one serving instance's card record.

        Cards are published per-instance (``models/{name}/{lease_id:x}``) and
        bound to that instance's lease, so a model disappears from frontends
        only when its *last* worker is gone — one process dying must not
        unregister a model other healthy workers still serve.
        """
        return f"{MODEL_PREFIX}/{self.name}/{lease_id:x}"

    @staticmethod
    def name_of_key(key: str) -> str:
        """models/{name}/{lease_hex} -> name (name itself may contain '/')."""
        inner = key[len(MODEL_PREFIX) + 1 :]
        return inner.rsplit("/", 1)[0]

    @property
    def supports_chat(self) -> bool:
        return "chat" in self.model_type

    @property
    def supports_completions(self) -> bool:
        return "completions" in self.model_type

    def to_bytes(self) -> bytes:
        d = dict(self.__dict__)
        d["endpoint"] = list(self.endpoint)
        return json.dumps(d).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ModelDeploymentCard":
        d = json.loads(data)
        d["endpoint"] = tuple(d.get("endpoint", ("dynamo", "backend", "generate")))
        return cls(**d)
