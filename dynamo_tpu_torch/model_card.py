"""Model Deployment Card (MDC): everything a frontend needs to serve a model
(a copy of ``dynamo_tpu/model_card.py``; the same fields and JSON record).

Workers publish their card into the discovery store under
``models/{name}/{lease_id:x}``; the frontend's ModelWatcher builds the client
pipeline (preprocessor -> backend -> router) from it. Cards carry *specs*
(tokenizer kind or path, template text) rather than live objects so they
serialize cleanly.

``from_model_dir`` builds a card from an HF checkpoint directory's
``config.json``, tokenizer files and ``tokenizer_config.json``;
``from_gguf`` from a GGUF file's metadata (its embedded tokenizer). Moving a
card's artifacts through an object store comes with the TCP runtime (A7).
"""

from __future__ import annotations

import json
import pathlib
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

    @classmethod
    def from_model_dir(cls, name: str, path: str | pathlib.Path, **overrides: Any) -> "ModelDeploymentCard":
        """Build a card from an HF-style model directory (config/tokenizer files)."""
        p = pathlib.Path(path)
        kw: dict[str, Any] = {"name": name}
        cfg_file = p / "config.json"
        if cfg_file.exists():
            cfg = json.loads(cfg_file.read_text())
            kw["context_length"] = cfg.get("max_position_embeddings", 4096)
            eos = cfg.get("eos_token_id")
            if isinstance(eos, int):
                kw["eos_token_ids"] = [eos]
            elif isinstance(eos, list):
                kw["eos_token_ids"] = list(eos)
            if isinstance(cfg.get("bos_token_id"), int):
                kw["bos_token_id"] = cfg["bos_token_id"]
        if (p / "tokenizer.json").exists():
            kw["tokenizer"] = str(p / "tokenizer.json")
        elif (p / "tokenizer.model").exists():  # SentencePiece-only checkpoint
            kw["tokenizer"] = str(p / "tokenizer.model")
        tc_file = p / "tokenizer_config.json"
        if tc_file.exists():
            tc = json.loads(tc_file.read_text())
            if tc.get("chat_template"):
                kw["chat_template"] = tc["chat_template"]
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_gguf(cls, name: str, path: str | pathlib.Path, *, reader: Any | None = None,
                  **overrides: Any) -> "ModelDeploymentCard":
        """Build a card from a GGUF file's metadata (embedded tokenizer,
        context length, special token ids, chat template). Pass an open
        ``reader`` to reuse an already-parsed header (the caller keeps
        ownership and closes it)."""
        from dynamo_tpu_torch.models.gguf import GGUFReader

        owned = reader is None
        reader = reader or GGUFReader(path)
        try:
            md = reader.metadata
            arch = md.get("general.architecture", "llama")
            kw: dict[str, Any] = {
                "name": name,
                "tokenizer": str(path),  # load_tokenizer understands .gguf
                "context_length": int(md.get(f"{arch}.context_length", 4096)),
            }
            if "tokenizer.ggml.eos_token_id" in md:
                kw["eos_token_ids"] = [int(md["tokenizer.ggml.eos_token_id"])]
            if "tokenizer.ggml.bos_token_id" in md:
                kw["bos_token_id"] = int(md["tokenizer.ggml.bos_token_id"])
            if md.get("tokenizer.chat_template"):
                kw["chat_template"] = md["tokenizer.chat_template"]
            kw.update(overrides)
            return cls(**kw)
        finally:
            if owned:
                reader.close()
