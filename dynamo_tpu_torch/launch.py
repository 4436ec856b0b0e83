"""Entry points of the port: build an engine service for a preset, and the
OpenAI request pipeline in front of it.

:func:`build_engine_service` is the counterpart of
``dynamo_tpu/launch.py:build_engine_service`` restricted to presets with
random-init (seeded) or bridged parameters; :func:`build_pipeline` returns
the ``OpenAIPreprocessor(Backend(service, tokenizer))`` chain the JAX
frontend's model manager builds. Serving it over HTTP with the discovery
runtime and the router in front is not ported yet.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import asyncio

import torch

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.engine.service import TorchEngineService
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.tokenizer import BaseTokenizer, ByteTokenizer

CONTEXT_LENGTH_CAP = 4096  # the JAX build's preset card: min(max_position, 4096)


async def build_engine_service(
    model: str,
    *,
    device: str | torch.device = "cuda",
    params: dict | None = None,
    seed: int = 0,
    cache_dtype: torch.dtype | None = None,
    on_kv_event=None,
    **engine_kw,
) -> TorchEngineService:
    """Bring up a started engine service for preset ``model``.

    ``params`` are the port's parameters (e.g. ``bridge.params_from_jax``);
    without them the weights are random-init from ``seed``. ``engine_kw``
    overrides :class:`EngineConfig` fields; the defaults are the JAX build's
    for a preset (byte-tokenizer EOS, 16-token pages, context capped at
    4096). Raises without a GPU unless ``device="cpu"``."""
    if model not in PRESETS:
        raise ValueError(f"unknown preset {model!r} (ported presets: {', '.join(PRESETS)})")
    dev = resolve_device(device)
    cfg = PRESETS[model]
    config = EngineConfig(**{
        "max_seq_len": min(cfg.max_position, CONTEXT_LENGTH_CAP),
        "eos_token_ids": tuple(sorted(ByteTokenizer().eos_token_ids)),
        "page_size": 16,
        **engine_kw,
    })

    def _build() -> TorchModelRunner:
        # Parameter init and cache allocation take seconds at full width:
        # keep them off the event loop.
        p = params if params is not None else llama.init_params(cfg, seed, device=dev)
        return TorchModelRunner(
            cfg, p, num_pages=config.num_pages, page_size=config.page_size,
            max_batch_size=config.max_batch_size, cache_dtype=cache_dtype, device=dev,
        )

    runner = await asyncio.get_running_loop().run_in_executor(None, _build)
    return await TorchEngineService(EngineCore(runner, config, on_kv_event=on_kv_event)).start()


def build_pipeline(
    service: TorchEngineService,
    tokenizer: BaseTokenizer | None = None,
    *,
    chat_template: str | None = None,
) -> OpenAIPreprocessor:
    """OpenAI body -> preprocessor -> backend (detokenize, stop strings) -> engine."""
    tokenizer = tokenizer or ByteTokenizer()
    context_length = service.core.config.max_seq_len
    return OpenAIPreprocessor(
        Backend(service, tokenizer),
        tokenizer,
        chat_template=chat_template,
        default_max_tokens=max(1, min(context_length // 2, 4096)),
    )

