"""ModelManager + ModelWatcher: dynamic model discovery for the frontend (a copy
of ``dynamo_tpu/frontend/model_manager.py`` for text models).

The manager holds, per model name, the client pipeline the HTTP handlers
call: ``OpenAIPreprocessor -> Backend -> (router/client engine)``. The
watcher keeps the manager in sync with the discovery store: workers publish
their ModelDeploymentCard under ``models/{name}`` bound to their lease, so a
model appears when its first worker comes up and vanishes (lease expiry /
delete) when the last one dies.

Parity: reference ModelManager (`http/service/model_manager.rs:33`) and
ModelWatcher (`discovery/watcher.rs:69-282`), SURVEY.md §3 call stack A.

The encode-worker handoff of vision-language models is not ported yet: a
card that names an image token is refused.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.model_card import MODEL_PREFIX, ModelDeploymentCard
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.discovery import WatchEventType
from dynamo_tpu_torch.router.router import build_kv_router
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)


class ClientEngine(AsyncEngine[Any, Any]):
    """Adapts a runtime endpoint Client to the AsyncEngine shape."""

    def __init__(self, client) -> None:
        self.client = client

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self.client.generate(request, context)


@dataclass
class ModelEntry:
    card: ModelDeploymentCard
    pipeline: AsyncEngine[Any, Any]
    client: Any = None  # runtime Client when discovery-built (None for local engines)
    aux: list[Any] = field(default_factory=list)  # closeables (kv subscriber, aggregator)


class ModelManager:
    def __init__(self) -> None:
        self._models: dict[str, ModelEntry] = {}

    def register(
        self, card: ModelDeploymentCard, pipeline: AsyncEngine[Any, Any], *, client: Any = None, aux: list[Any] | None = None
    ) -> None:
        self._models[card.name] = ModelEntry(card, pipeline, client, aux or [])
        logger.info("model registered: %s (%s)", card.name, card.model_type)

    async def remove(self, name: str) -> None:
        entry = self._models.pop(name, None)
        if entry is not None:
            if entry.client is not None:
                await entry.client.close()
            for a in entry.aux:
                await a.close()
        logger.info("model removed: %s", name)

    def get(self, name: str) -> ModelEntry | None:
        return self._models.get(name)

    def names(self) -> list[str]:
        return sorted(self._models)

    def cards(self) -> list[ModelDeploymentCard]:
        return [e.card for e in self._models.values()]


async def build_pipeline(
    runtime: DistributedRuntime, card: ModelDeploymentCard
) -> tuple[AsyncEngine[Any, Any], Any, list[Any]]:
    """Construct the frontend-side pipeline for a discovered model.

    Returns (pipeline, client, aux_closeables). ``card.router_mode == "kv"``
    builds the KV-aware routing stack; round_robin and random route through
    a plain endpoint client. (The JAX build's ``router_factory`` hook for
    custom policies is not ported: no caller of the port needs one.)
    """
    if card.extra.get("image_token_id") is not None or card.extra.get("video_token_id") is not None:
        raise NotImplementedError(
            f"model {card.name!r} takes images: the encode-worker path is not ported to dynamo_tpu_torch yet"
        )
    # Real tokenizer files take a while to parse — keep it off the event loop.
    tokenizer = await asyncio.get_running_loop().run_in_executor(None, load_tokenizer, card.tokenizer)
    aux: list[Any] = []
    ns, comp, ep = card.endpoint
    if card.router_mode == "kv":
        engine, subscriber, aggregator = await build_kv_router(
            runtime, namespace=ns, component=comp, endpoint=ep, block_size=card.kv_page_size
        )
        client = engine.client
        aux = [subscriber, aggregator]
    else:
        mode = card.router_mode if card.router_mode in ("round_robin", "random") else "round_robin"
        client = runtime.namespace(ns).component(comp).endpoint(ep).client(router_mode=mode)
        engine = ClientEngine(client)
    pre = OpenAIPreprocessor(
        Backend(engine, tokenizer),
        tokenizer,
        chat_template=card.chat_template,
        default_max_tokens=max(1, min(card.context_length // 2, 4096)),
    )
    return pre, client, aux


class ModelWatcher:
    """Keeps a ModelManager synchronized with the discovery store."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        manager: ModelManager,
    ) -> None:
        self.runtime = runtime
        self.manager = manager
        self._task: asyncio.Task | None = None
        # Cards are per-instance records (models/{name}/{lease}); a model is
        # removed only when its last record vanishes.
        self._card_keys: dict[str, set[str]] = {}

    async def start(self) -> "ModelWatcher":
        if self._task is None:
            # Seed from the current store state, then follow the watch.
            prefix = MODEL_PREFIX + "/"
            for key, value in (await self.runtime.store.get_prefix(prefix)).items():
                await self._on_put(key, value)
            self._task = asyncio.create_task(self._watch(), name="model-watcher")
        return self

    async def _on_put(self, key: str, value: bytes) -> None:
        card = ModelDeploymentCard.from_bytes(value)
        self._card_keys.setdefault(card.name, set()).add(key)
        if self.manager.get(card.name) is not None:
            return  # another worker instance of an already-known model
        pipeline, client, aux = await build_pipeline(self.runtime, card)
        self.manager.register(card, pipeline, client=client, aux=aux)

    async def _on_delete(self, key: str) -> None:
        name = ModelDeploymentCard.name_of_key(key)
        keys = self._card_keys.get(name)
        if keys is not None:
            keys.discard(key)
            if keys:
                return  # other workers still serve this model
            del self._card_keys[name]
        await self.manager.remove(name)

    async def _watch(self) -> None:
        prefix = MODEL_PREFIX + "/"
        try:
            async for event in self.runtime.store.watch_prefix(prefix):
                try:
                    if event.type is WatchEventType.PUT and event.value is not None:
                        await self._on_put(event.key, event.value)
                    elif event.type is WatchEventType.DELETE:
                        await self._on_delete(event.key)
                except Exception:
                    logger.exception("model watch event failed: %s", event)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("model watcher terminated")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
