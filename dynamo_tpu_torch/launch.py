"""Entry points of the port: build an engine service for a preset, serve it on
the discovery runtime, and serve the OpenAI HTTP frontend in front of it
(the counterpart of ``dynamo_tpu/launch.py``'s single-process path).

- :func:`build_engine_service` — the counterpart of
  ``dynamo_tpu/launch.py:build_engine_service``: ``model`` is a preset
  (random-init, seeded, or bridged parameters) or an HF checkpoint
  directory (``config.json``, safetensors, tokenizer), whose card, tokenizer
  and weights (``models/loader.py``) are the JAX build's
  ``WorkerSpec.from_model_dir``, or a GGUF file (``models/gguf.py``: its
  config, card, embedded tokenizer and weights); ``quantize`` serves the
  weights as int8 or packed int4 (``models/quant.py``).
- :func:`build_pipeline` — the ``OpenAIPreprocessor(Backend(service,
  tokenizer))`` chain over one service, in-process, with no runtime.
- :func:`serve_worker` — one engine on a runtime endpoint with its KV event
  stream and load metrics, and its ModelDeploymentCard published
  (lease-bound) so frontends discover it.
- :func:`serve_frontend` — ModelManager + ModelWatcher + OpenAI HttpService.
- :func:`run_local` — N workers and the frontend in one process over the
  in-memory runtime, round-robin, random or KV-routed.
- CLI: ``python -m dynamo_tpu_torch.launch --model llama-3.2-1b --workers 2
  --router-mode kv --http-port 8080`` (``--model`` also takes a routed-MoE
  preset such as ``olmoe-1b-7b``, whose experts run in the grouped kernel of
  ``ops/grouped_matmul.py``, a checkpoint directory or a ``.gguf`` file; ``--platform cpu`` runs on the CPU;
  ``--quantize int8|int4`` serves weight-only quantized weights through the
  quant_matmul kernel; ``--kv-cache-dtype fp8``,
  or ``DYN_KV_CACHE_DTYPE=fp8``, stores the KV cache as fp8 e4m3, served by
  the kernels' fp8 forms; ``--overlap``, or ``DYN_OVERLAP=1``, runs the
  engine's overlapped pipeline; ``--spec-k K``, or ``DYN_SPEC_K``, drafts
  K tokens a row for a speculative verify; ``--decode-steps K``, or
  ``DYNAMO_DECODE_STEPS``, fuses K decode steps a dispatch; ``--g2-blocks
  N`` / ``--g3-blocks N`` put N-block host-RAM / disk KV tiers behind the
  card's pages, each worker with a G3 directory of its own under the
  temporary directory, ``DYN_ASYNC_ONBOARD=1`` fetching their pages off the
  step loop; ``DYN_CONSTRAINT_LOOKAHEAD_TOKENS`` caps the constrained
  lookahead of ``response_format: json_object`` requests, whose masks a
  daemon thread warms at worker start unless ``DYNAMO_WARM_CONSTRAINTS=0``;
  ``DYN_SLO_SCHED=1`` orders each worker's intake by deadline slack under
  per-tenant quotas (``DYN_SLO_SCHED_*``, ``DYN_TENANT_*``) and arms the KV
  router's attainment term, ``DYN_CACHE_AWARE=1`` prices admission and
  routing by uncached prefill tokens (``DYN_CACHE_AWARE_*``) and onboards
  tier pages in the background; ``DYN_FLIGHT_DUMP_DIR`` is where a worker
  whose step fails dumps its flight recorder).

On the card every engine step replays a CUDA graph (``TorchModelRunner``).

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.

Not ported yet: the multi-process roles (``--role``, the TCP store and
transport), disaggregated prefill workers, the ``text`` and ``batch:``
inputs, vision checkpoints, the worker telemetry plane, and
the JAX build's other engine options (``--g4-blocks``, ...). Each is
refused by name.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import pathlib
import tempfile
import threading
from typing import Any

import torch

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.blocks import BlockManagerConfig, KvBlockManager
from dynamo_tpu_torch.config import env_flag
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.engine.service import TorchEngineService
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.metrics import FrontendMetrics
from dynamo_tpu_torch.frontend.model_manager import ModelManager, ModelWatcher
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.models.quant import init_params_quantized, quantize_params
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.router.events import KV_EVENTS_ENDPOINT, KvEventBroadcaster
from dynamo_tpu_torch.router.metrics import WorkerMetricsPublisher
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.tokenizer import BaseTokenizer, ByteTokenizer, load_tokenizer

logger = logging.getLogger(__name__)

CONTEXT_LENGTH_CAP = 4096  # the JAX build's preset card: min(max_position, 4096)


def _kv_cache_dtype():
    """Resolve DYN_KV_CACHE_DTYPE / DYN_WORKER_KV_CACHE_DTYPE to a torch dtype.

    'bf16' (or unset) -> None: the runner keeps its model-dtype default.
    'fp8' -> float8_e4m3fn storage; every attention path upcasts fp8 KV to
    bf16 (the kernels) or the query dtype (the reference path) at the
    matmul, so this only changes the cache's footprint and rounding.
    """
    name = (
        os.environ.get("DYN_KV_CACHE_DTYPE")
        or os.environ.get("DYN_WORKER_KV_CACHE_DTYPE", "")
    ).strip().lower()
    if name in ("", "bf16", "bfloat16"):
        return None
    if name in ("fp8", "float8_e4m3fn", "fp8_e4m3"):
        return torch.float8_e4m3fn
    raise ValueError(f"unsupported kv cache dtype: {name!r} (want bf16 or fp8)")


def _overlap() -> bool:
    """Resolve DYN_OVERLAP / DYN_WORKER_OVERLAP (``--overlap`` sets the
    latter): the engine's overlapped pipeline, off unless either is truthy."""
    return env_flag(os.environ, "DYN_OVERLAP") or env_flag(os.environ, "DYN_WORKER_OVERLAP")


def _engine_env() -> dict[str, Any]:
    """The engine fields the JAX launcher reads from the environment
    (``dynamo_tpu/launch.py:WorkerSpec._engine_cfg``): ``decode_steps`` from
    DYNAMO_DECODE_STEPS / DYN_WORKER_DECODE_STEPS (``--decode-steps`` sets
    the latter), ``spec_k`` from DYN_SPEC_K / DYN_WORKER_SPEC_K
    (``--spec-k``), ``overlap`` (:func:`_overlap`), ``overlap_spec``,
    on unless DYN_OVERLAP_SPEC or DYN_WORKER_OVERLAP_SPEC is false,
    ``async_onboard`` from DYN_ASYNC_ONBOARD or DYN_CACHE_AWARE (residual
    pricing assumes tier hits are cheap, which they are only in the
    background), ``constraint_lookahead_tokens`` from
    DYN_CONSTRAINT_LOOKAHEAD_TOKENS (default 32), and ``slo_sched`` /
    ``cache_aware``, present only when DYN_SLO_SCHED / DYN_CACHE_AWARE is
    set (both default off)."""
    fields = {
        "decode_steps": int(os.environ.get("DYNAMO_DECODE_STEPS") or os.environ.get("DYN_WORKER_DECODE_STEPS", "1")),
        "spec_k": int(os.environ.get("DYN_SPEC_K") or os.environ.get("DYN_WORKER_SPEC_K", "0")),
        "overlap": _overlap(),
        "overlap_spec": (env_flag(os.environ, "DYN_OVERLAP_SPEC", default=True)
                         and env_flag(os.environ, "DYN_WORKER_OVERLAP_SPEC", default=True)),
        "async_onboard": env_flag(os.environ, "DYN_ASYNC_ONBOARD") or env_flag(os.environ, "DYN_CACHE_AWARE"),
        "constraint_lookahead_tokens": int(os.environ.get("DYN_CONSTRAINT_LOOKAHEAD_TOKENS", "32")),
    }
    for field, flag in (("slo_sched", "DYN_SLO_SCHED"), ("cache_aware", "DYN_CACHE_AWARE")):
        if env_flag(os.environ, flag):
            fields[field] = True
    return fields


def resolve_model(model: str) -> tuple[ModelConfig, pathlib.Path | None]:
    """``model`` as the JAX launcher resolves it (``make_worker_spec``): a
    preset name, a path to an HF checkpoint directory, whose config is read
    from its ``config.json`` under the directory's name, or a ``.gguf``
    file, whose config comes from its metadata under the file's stem (one
    cached reader serves config, card, tokenizer and weights). Returns the
    config and the directory or file (None for a preset)."""
    if model in PRESETS:
        return PRESETS[model], None
    p = pathlib.Path(model)
    if p.is_dir():
        return ModelConfig.from_hf(p / "config.json", name=p.name), p
    if p.suffix == ".gguf" and p.is_file():
        from dynamo_tpu_torch.models.gguf import config_from_gguf, shared_reader

        return config_from_gguf(shared_reader(p), name=p.stem), p
    raise ValueError(f"unknown model {model!r}: not a preset ({', '.join(PRESETS)}), a checkpoint directory, "
                     "or a .gguf file")


def model_card(cfg: ModelConfig, path: pathlib.Path, **overrides: Any) -> ModelDeploymentCard:
    """The card of a checkpoint directory or a GGUF file."""
    if path.suffix == ".gguf":
        from dynamo_tpu_torch.models.gguf import shared_reader

        return ModelDeploymentCard.from_gguf(cfg.name, path, reader=shared_reader(path), **overrides)
    return ModelDeploymentCard.from_model_dir(cfg.name, path, **overrides)


def worker_params(cfg: ModelConfig, path: pathlib.Path | None, *, device: torch.device, seed: int = 0,
                 quantize: str = "") -> dict:
    """The parameters a worker serves, in the JAX launcher's order
    (``dynamo_tpu/launch.py:256-290``): a preset random-inits from ``seed``,
    directly quantized with ``quantize`` (the full-width tree never exists);
    a directory loads its safetensors, then quantizes leaf by leaf in place
    on the device; a GGUF file imports its Q4_0/Q4_K projections straight
    into packed int4 leaves with ``quantize="int4"``, and every leaf that
    fell back is quantized after."""
    if path is None:
        return init_params_quantized(cfg, seed, mode=quantize, device=device)
    if path.suffix == ".gguf":
        from dynamo_tpu_torch.models.gguf import load_gguf_params, shared_reader

        params = load_gguf_params(shared_reader(path), cfg, quantize=quantize, device=device)
    else:
        from dynamo_tpu_torch.models.loader import load_params

        params = load_params(path, cfg, device=device)
    return quantize_params(params, mode=quantize, inplace=True)


async def build_engine_service(
    model: str,
    *,
    device: str | torch.device = "cuda",
    params: dict | None = None,
    seed: int = 0,
    cache_dtype: torch.dtype | None = None,
    graphs: bool | None = None,
    quantize: str = "",
    on_kv_event=None,
    block_manager_config: BlockManagerConfig | None = None,
    **engine_kw,
) -> TorchEngineService:
    """Bring up a started engine service for ``model``: a preset, an HF
    checkpoint directory or a GGUF file (:func:`resolve_model`).

    ``params`` are the port's parameters (e.g. ``bridge.params_from_jax``);
    without them a preset's weights are random-init from ``seed``, a
    directory's are loaded from its safetensors (``models/loader.py``) and a
    GGUF file's from its tensors (``models/gguf.py``). ``quantize`` ("",
    "int8" or "int4") serves the matmul weights quantized (:func:`worker_params`;
    given ``params`` are quantized where they are not already).
    ``engine_kw`` overrides :class:`EngineConfig` fields; the defaults are
    the JAX build's: for a preset byte-tokenizer EOS, 16-token pages and the
    context capped at 4096, for a directory its card's context length, EOS
    ids and page size; ``decode_steps``, ``spec_k``, ``overlap``,
    ``overlap_spec``, ``slo_sched``, ``cache_aware``, ``async_onboard`` and
    ``constraint_lookahead_tokens`` from the environment (:func:`_engine_env`).
    ``cache_dtype`` None takes :func:`_kv_cache_dtype` (the environment;
    unset keeps the model's dtype). ``graphs`` is the runner's (None: CUDA
    graphs on the card). ``block_manager_config`` puts the G2/G3 KV tiers
    behind the pages, reading and writing them through the runner. The
    engine takes the card's tokenizer for json_mode requests, warmed on a
    daemon thread unless DYNAMO_WARM_CONSTRAINTS=0. Raises without a GPU
    unless ``device="cpu"``."""
    cfg, model_dir = resolve_model(model)
    dev = resolve_device(device)
    if cache_dtype is None:
        cache_dtype = _kv_cache_dtype()
    if model_dir is None:
        defaults = {"max_seq_len": min(cfg.max_position, CONTEXT_LENGTH_CAP),
                    "eos_token_ids": tuple(sorted(ByteTokenizer().eos_token_ids)), "page_size": 16}
    else:
        card = model_card(cfg, model_dir)
        defaults = {"max_seq_len": card.context_length, "eos_token_ids": tuple(card.eos_token_ids),
                    "page_size": card.kv_page_size}
    config = EngineConfig(**{**defaults, **_engine_env(), **engine_kw})

    def _build() -> TorchModelRunner:
        # Parameter init or loading and cache allocation take seconds at
        # full width: keep them off the event loop.
        if params is not None:
            p = quantize_params(params, mode=quantize)
        else:
            p = worker_params(cfg, model_dir, device=dev, seed=seed, quantize=quantize)
        return TorchModelRunner(
            cfg, p, num_pages=config.num_pages, page_size=config.page_size,
            max_batch_size=config.max_batch_size, cache_dtype=cache_dtype, device=dev, graphs=graphs,
            verify_width=config.spec_k + 1,
        )

    runner = await asyncio.get_running_loop().run_in_executor(None, _build)
    block_manager = None
    if block_manager_config is not None:
        block_manager = KvBlockManager(block_manager_config, read_page=runner.read_page,
                                       write_page=runner.write_page, write_pages=runner.write_pages)
    core = EngineCore(runner, config, on_kv_event=on_kv_event, block_manager=block_manager)
    tokenizer_spec = worker_card(model, config).tokenizer
    core.set_constraint_tokenizer_factory(lambda: load_tokenizer(tokenizer_spec))
    if os.environ.get("DYNAMO_WARM_CONSTRAINTS", "1") != "0":
        threading.Thread(target=core.warm_constraints, daemon=True, name="constraint-warmup").start()
    return await TorchEngineService(core).start()


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


def worker_card(model: str, config: EngineConfig, *, router_mode: str = "round_robin") -> ModelDeploymentCard:
    """The card a worker of ``model`` publishes. A preset's is the JAX
    build's preset card (byte tokenizer, no chat template); a checkpoint
    directory's is ``ModelDeploymentCard.from_model_dir`` (its tokenizer
    file and chat template), a GGUF file's ``from_gguf`` (its embedded
    tokenizer). Each carries the served engine's context length, page size
    and EOS ids."""
    served = dict(context_length=config.max_seq_len, kv_page_size=config.page_size,
                  eos_token_ids=list(config.eos_token_ids), router_mode=router_mode)
    cfg, model_dir = resolve_model(model)
    if model_dir is not None:
        return model_card(cfg, model_dir, **served)
    return ModelDeploymentCard(name=model, tokenizer="byte", **served)


async def serve_worker(
    runtime: DistributedRuntime,
    model: str,
    *,
    lease=None,
    router_mode: str = "round_robin",
    device: str | torch.device = "cuda",
    params: dict | None = None,
    seed: int = 0,
    cache_dtype: torch.dtype | None = None,
    quantize: str = "",
    block_manager_config: BlockManagerConfig | None = None,
    **engine_kw: Any,
) -> TorchEngineService:
    """Serve the engine + KV event stream + metrics and publish the model card.

    The allocator emits KV events from the executor thread that runs each
    engine step; the broadcaster, bound to this loop, hands them over with
    ``call_soon_threadsafe``. ``lease`` gives the worker its own instance
    identity (several workers on one runtime); the primary lease otherwise.
    """
    broadcaster = KvEventBroadcaster()
    broadcaster.bind_loop(asyncio.get_running_loop())
    service = await build_engine_service(
        model, device=device, params=params, seed=seed, cache_dtype=cache_dtype, quantize=quantize,
        on_kv_event=broadcaster.publish, block_manager_config=block_manager_config, **engine_kw,
    )
    broadcaster.bind_snapshot(service.core.allocator.cache_snapshot)
    card = worker_card(model, service.core.config, router_mode=router_mode)
    ns, comp, ep = card.endpoint
    component = runtime.namespace(ns).component(comp)
    instance = await component.endpoint(ep).serve(service, metadata={"model": card.name}, lease=lease)
    await component.endpoint(KV_EVENTS_ENDPOINT).serve(broadcaster, metadata={"model": card.name}, lease=lease)
    # The aggregator keys load metrics by this id, and the router picks it.
    service.core.config.worker_id = instance.lease_id

    def snapshot():
        m = service.metrics()
        m.worker_id = instance.lease_id
        return m

    publisher = await WorkerMetricsPublisher(
        runtime, ns, comp, instance.lease_id, snapshot, interval=0.5, lease=lease
    ).start()
    service.aux.append(publisher)  # closed with the service
    card_lease = lease or await runtime.primary_lease()
    await runtime.store.put(card.instance_key(instance.lease_id), card.to_bytes(), lease_id=card_lease.id)
    logger.info("worker serving %s as instance %x", card.name, instance.lease_id)
    return service


async def serve_frontend(
    runtime: DistributedRuntime,
    *,
    host: str = "0.0.0.0",
    port: int = 8080,
    clear_kv_hook=None,
) -> tuple[HttpService, ModelWatcher, int]:
    manager = ModelManager()
    watcher = await ModelWatcher(runtime, manager).start()
    service = HttpService(manager, metrics=FrontendMetrics(), clear_kv_hook=clear_kv_hook)
    actual_port = await service.start(host, port)
    return service, watcher, actual_port


async def run_local(
    preset: str = "test-tiny",
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    num_workers: int = 1,
    router_mode: str = "round_robin",
    device: str | torch.device = "cuda",
    seed: int = 0,
    params: dict | None = None,
    cache_dtype: torch.dtype | None = None,
    quantize: str = "",
    g2_blocks: int = 0,
    g3_blocks: int = 0,
    **engine_kw: Any,
) -> dict[str, Any]:
    """Single-process serving: ``num_workers`` workers + the frontend.

    ``preset`` is a preset name, a checkpoint directory or a GGUF file
    (:func:`resolve_model`). Every worker takes the same ``params``, or
    random-inits from the same ``seed`` (a directory or file: loads its
    weights), as the JAX build's workers do; ``quantize`` ("", "int8",
    "int4") as in :func:`build_engine_service`. ``g2_blocks``/``g3_blocks``
    give every worker host-RAM/disk KV tiers of that many blocks, worker i's
    disk tier in ``dynamo_tpu_torch_g3_w{i}`` under the temporary directory.
    Raises without a GPU unless ``device="cpu"``, before anything is
    started."""
    resolve_device(device)
    if router_mode not in ("round_robin", "random", "kv"):
        raise ValueError(f"unknown router mode {router_mode!r} (want round_robin, random or kv)")
    runtime = DistributedRuntime.detached()
    services: list[TorchEngineService] = []
    for i in range(num_workers):
        # Each worker needs its own lease/instance: secondary leases per worker.
        lease = await runtime.secondary_lease() if num_workers > 1 else None
        tiers = None
        if g2_blocks or g3_blocks:
            tiers = BlockManagerConfig(g2_capacity_blocks=g2_blocks, g3_capacity_blocks=g3_blocks,
                                       g3_path=os.path.join(tempfile.gettempdir(), f"dynamo_tpu_torch_g3_w{i}"))
        services.append(await serve_worker(
            runtime, preset, lease=lease, router_mode=router_mode, device=device, params=params,
            seed=seed, cache_dtype=cache_dtype, quantize=quantize, block_manager_config=tiers, **engine_kw,
        ))

    def clear(core: EngineCore) -> int:
        # Steps run in the executor under step_lock: clearing under it cannot
        # interleave with a step's page allocation.
        with core.step_lock:
            n = core.allocator.clear_cache()
            if core.block_manager is not None:
                n += core.block_manager.clear()
            return n

    async def clear_all() -> int:
        loop = asyncio.get_running_loop()
        return sum([await loop.run_in_executor(None, clear, s.core) for s in services])

    http, watcher, actual_port = await serve_frontend(runtime, host=host, port=port, clear_kv_hook=clear_all)
    return {
        "runtime": runtime,
        "services": services,
        "http": http,
        "watcher": watcher,
        "port": actual_port,
    }


async def shutdown(handles: dict[str, Any]) -> None:
    """Tear down a :func:`run_local` stack: the frontend, the watcher, the
    frontend's models (their clients and router subscriptions), every
    worker, then the runtime; each step isolated, in one shielded task, so a
    Ctrl-C arriving during teardown cannot skip the later closes."""
    manager = handles["http"].manager

    async def _teardown() -> None:
        for closer in (
            handles["http"].stop,
            handles["watcher"].close,
            *(lambda name=name: manager.remove(name) for name in manager.names()),
            *(svc.close for svc in handles["services"]),
            handles["runtime"].close,
        ):
            try:
                await closer()
            except Exception:
                logger.exception("teardown step %r failed", closer)

    task = asyncio.ensure_future(_teardown())
    try:
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if not task.done():
            await asyncio.wait([task])
        raise


async def _amain(args: argparse.Namespace, *, device: str | torch.device = "cuda", seed: int = 0,
                 params: dict | None = None) -> None:
    handles = await run_local(
        args.model,
        host=args.host,
        port=args.http_port,
        num_workers=args.workers,
        router_mode=args.router_mode,
        device=args.platform or device,
        seed=seed,
        params=params,
        quantize=args.quantize,
        num_pages=args.num_pages,
        max_batch_size=args.max_batch_size,
        g2_blocks=args.g2_blocks,
        g3_blocks=args.g3_blocks,
    )
    logger.info("serving %s on port %d", args.model, handles["port"])
    try:
        await asyncio.Event().wait()
    finally:
        await shutdown(handles)


def build_parser() -> argparse.ArgumentParser:
    """The JAX launcher's options that the port takes, with its names and
    defaults (``--platform`` picks the port's device instead of a JAX
    platform)."""
    parser = argparse.ArgumentParser(
        description="dynamo-tpu launcher (PyTorch/CUDA port)", allow_abbrev=False,
        epilog="environment: DYN_SLO_SCHED=1 admits each worker's requests by deadline slack under per-tenant "
               "quotas (DYN_SLO_SCHED_*, DYN_TENANT_QUOTAS) and arms the KV router's attainment term; "
               "DYN_CACHE_AWARE=1 prices admission and routing by uncached prefill tokens "
               "(DYN_CACHE_AWARE_*) and onboards tier pages in the background; DYN_FLIGHT_DUMP_DIR holds "
               "the flight recorder dump of a worker whose step failed; DYN_FAULTS arms fault points. "
               "MoE presets (olmoe-1b-7b, qwen3-30b-a3b, deepseek-v2-lite, ...) and MoE checkpoints run their "
               "experts in the grouped kernel; DYNAMO_MOE_DISPATCH=dense runs decode-sized MoE batches densely.")
    parser.add_argument("--model", default="test-tiny",
                        help=f"model preset ({', '.join(PRESETS)}), an HF checkpoint directory or a .gguf file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8080)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--num-pages", type=int, default=512)
    parser.add_argument("--max-batch-size", type=int, default=64)
    parser.add_argument("--router-mode", default="round_robin", choices=["round_robin", "random", "kv"])
    parser.add_argument("--role", default="local", choices=["local"],
                        help="only 'local' (workers and frontend in this process) is ported")
    parser.add_argument("--input", default="http", choices=["http"], help="only 'http' is ported")
    parser.add_argument(
        "--quantize", default="", choices=["", "int8", "int4"],
        help="weight-only quantization for serving (int4: packed nibbles, "
        "group scales of DYN_QUANT_GROUP_SIZE, default 128); refused for MoE models",
    )
    parser.add_argument("--platform", default=None, choices=["cuda", "cpu"],
                        help="device to serve on (default: the card)")
    parser.add_argument("--kv-cache-dtype", default="bf16", choices=["bf16", "fp8"],
                        help="KV-cache storage dtype; fp8 halves KV memory (attention upcasts at the matmul)")
    parser.add_argument("--overlap", action="store_true", default=False,
                        help="overlapped execution: depth-1 pipeline with device-resident token feedback "
                             "(DYN_OVERLAP); output streams stay bit-identical to off")
    parser.add_argument("--decode-steps", type=int, default=1, help="fused decode steps per device dispatch")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative decoding draft length (lossless n-gram self-drafting fused into "
                             "mixed steps); 0 = off")
    parser.add_argument("--g2-blocks", type=int, default=0, help="host-RAM KV tier capacity (blocks); 0 disables")
    parser.add_argument("--g3-blocks", type=int, default=0, help="disk KV tier capacity (blocks); 0 disables")
    return parser


def main(argv: list[str] | None = None, *, device: str | torch.device = "cuda", seed: int = 0,
         params: dict | None = None) -> None:
    """``python -m dynamo_tpu_torch.launch``: serve until interrupted.

    An option of the JAX launcher that the port does not take yet (``--mesh``,
    ``--store``, ``--prefill-workers``, ...) is refused by name, never
    ignored. ``device``, ``seed`` and ``params`` are for callers in Python."""
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"not supported by dynamo_tpu_torch yet: {' '.join(unknown)}")
    if args.kv_cache_dtype != "bf16":
        os.environ["DYN_WORKER_KV_CACHE_DTYPE"] = args.kv_cache_dtype
    if args.overlap:
        os.environ["DYN_WORKER_OVERLAP"] = "1"
    if args.decode_steps != 1:
        os.environ["DYN_WORKER_DECODE_STEPS"] = str(args.decode_steps)
    if args.spec_k != 0:
        os.environ["DYN_WORKER_SPEC_K"] = str(args.spec_k)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(_amain(args, device=device, seed=seed, params=params))


if __name__ == "__main__":
    main()
