"""Model architecture config + the presets this slice serves.

A copy of ``dynamo_tpu/models/config.py:ModelConfig`` (same fields, so a
config converts either way with ``dataclasses.asdict``) restricted to the
presets the port runs: the CPU test models (dense GQA, MLA and the two tiny
MoE models), the dense widths served on the card (the Llama-3 models,
DeepSeek-R1-Distill-8B, Qwen2.5-7B, Qwen3-8B and the dense-trunk MLA proxy)
and the routed-MoE ones (OLMoE, Qwen3-MoE, Mixtral, Qwen1.5-MoE,
DeepSeek-V2-Lite and the DeepSeek-V3 shape). ``ModelConfig.from_hf`` reads
an HF ``config.json`` as the JAX build does.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    rms_eps: float = 1e-5
    max_position: int = 131072
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # MoE fields (0 experts = dense).
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_intermediate_size: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert_size: int = 0
    shared_expert_gated: bool = False
    moe_scoring: str = "softmax"
    moe_norm_topk: bool = True
    moe_routed_scaling: float = 1.0
    moe_n_group: int = 0
    moe_topk_group: int = 0
    moe_router_bias: bool = False
    first_k_dense: int = 0
    # Biases on q/k/v projections (Qwen2 family).
    attention_bias: bool = False
    # Gemma family: GeGLU MLP, zero-centered norm weights, sqrt(hidden) embeds.
    mlp_act: str = "silu"  # "silu" | "gelu_tanh"
    norm_plus_one: bool = False
    embed_scale: bool = False
    # Q/K RMS-norm before rope: "" (none), "head" (Qwen3), "flat" (OLMoE).
    qk_norm: str = ""
    sliding_window: int = 0
    image_token_id: int | None = None
    mrope_section: tuple | None = None
    video_token_id: int | None = None
    attn_type: str = "gqa"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def kv_bytes_per_token(self, itemsize: int | None = None) -> int:
        """Bytes of KV cache per token across all layers (2 = K and V; MLA
        caches one latent + rope key instead). ``itemsize`` overrides the
        dtype-derived cache element size (e.g. a bf16 cache for an f32
        model, or 1 for an fp8 cache)."""
        if itemsize is None:
            itemsize = 2 if self.dtype == "bfloat16" else 4
        if self.attn_type == "mla":
            from .mla import mla_cache_widths  # mla imports this module

            # Physical bytes: the latent and the padded rope stream.
            return self.num_layers * sum(mla_cache_widths(self)) * itemsize
        return 2 * self.num_layers * self.kv_dim * itemsize

    @classmethod
    def from_hf(cls, config: dict[str, Any] | str | pathlib.Path, *, name: str | None = None) -> "ModelConfig":
        """Build from an HF ``config.json`` dict or path (Llama/Qwen-style
        keys): the JAX build's ``ModelConfig.from_hf`` field for field, for
        the configs the port serves (dense Llama-family GQA, Qwen2 with QKV
        biases, Gemma-1, Qwen3, OLMoE, the routed-MoE families and DeepSeek's
        MLA). A config with a sliding window or a vision tower raises
        ``NotImplementedError`` naming the field (ROADMAP A6)."""
        if not isinstance(config, dict):
            config = json.loads(pathlib.Path(config).read_text())
        if "vision_config" in config:
            raise NotImplementedError(
                "config field 'vision_config': multimodal checkpoints are not ported to "
                "dynamo_tpu_torch yet (ROADMAP A6)")
        cfg = cls._from_hf_fields(config, name=name)
        if cfg.sliding_window:
            raise NotImplementedError(
                f"config field 'sliding_window' = {cfg.sliding_window}: sliding-window attention is not "
                "ported to dynamo_tpu_torch yet (ROADMAP A6)")
        return cfg

    @classmethod
    def _from_hf_fields(cls, config: dict[str, Any], *, name: str | None = None) -> "ModelConfig":
        """The JAX build's field mapping (``dynamo_tpu/models/config.py:from_hf``)."""
        if config.get("model_type") in ("gemma2", "gemma3", "gemma3_text"):
            # Gemma-2/3 add logit softcapping and alternating local/global
            # attention; running them through Gemma-1 math would silently
            # produce wrong logits. Refuse loudly.
            raise ValueError(
                f"model_type {config['model_type']!r} is unsupported "
                "(Gemma-2/3 softcapping + alternating-window attention); "
                "supported Gemma family: model_type 'gemma'"
            )
        hidden = config["hidden_size"]
        heads = config["num_attention_heads"]
        # DeepSeek replaces the first k MoE layers with dense MLPs
        # (first_k_dense_replace). k >= num_layers collapses to a plain
        # dense model; mixed stacks (0 < k < layers, real V2/V3) carry
        # first_k_dense through to the dense_layers/layers subtree split
        # (models/llama.py dual scan, models/loader._leaf_specs).
        first_dense = int(config.get("first_k_dense_replace", 0) or 0)
        all_dense = first_dense >= config["num_hidden_layers"]
        return cls(
            name=name or config.get("_name_or_path", config.get("model_type", "model")),
            vocab_size=config["vocab_size"],
            hidden_size=hidden,
            num_layers=config["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=config.get("num_key_value_heads", heads),
            head_dim=config.get("head_dim") or hidden // heads,
            intermediate_size=config["intermediate_size"],
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            rms_eps=config.get("rms_norm_eps", 1e-5),
            max_position=config.get("max_position_embeddings", 8192),
            tie_embeddings=config.get("tie_word_embeddings", False),
            num_experts=(n_experts := 0 if all_dense else (
                config.get("num_experts", config.get("num_local_experts", config.get("n_routed_experts", 0))) or 0
            )),
            num_experts_per_token=(config.get("num_experts_per_tok", 0) or 0) if n_experts else 0,
            # Mixtral stores the expert width in intermediate_size itself.
            moe_intermediate_size=((config.get("moe_intermediate_size", 0) or 0) or config["intermediate_size"]) if n_experts else 0,
            # Qwen2-MoE names the width directly; DeepSeek counts experts.
            shared_expert_size=((config.get("shared_expert_intermediate_size", 0) or 0)
            or (config.get("n_shared_experts", 0) or 0) * (config.get("moe_intermediate_size", 0) or 0)) if n_experts else 0,
            shared_expert_gated=config.get("model_type") == "qwen2_moe",
            # Native transformers' DeepseekV3Config does not serialize
            # scoring_func (its modeling hardcodes sigmoid routing), so a
            # missing key on deepseek_v3 means sigmoid — same model_type
            # fallback as moe_router_bias below.
            moe_scoring=config.get(
                "scoring_func",
                "sigmoid" if config.get("model_type") == "deepseek_v3" else "softmax",
            ) if n_experts else "softmax",
            # Mixtral renormalizes unconditionally (no config key) and
            # DeepSeek-V3 defaults norm_topk_prob=True; Qwen2-MoE/V2 default
            # False (real checkpoints set the key explicitly either way).
            moe_norm_topk=bool(config.get(
                "norm_topk_prob", config.get("model_type") in ("mixtral", "deepseek_v3")
            )),
            moe_routed_scaling=float(config.get("routed_scaling_factor", 1.0) or 1.0),
            moe_n_group=(config.get("n_group", 0) or 0) if n_experts else 0,
            moe_topk_group=(config.get("topk_group", 0) or 0) if n_experts else 0,
            # noaux_tc correction bias: native transformers' DeepseekV3Config
            # doesn't serialize topk_method, but its modeling always creates
            # e_score_correction_bias — key off model_type too.
            moe_router_bias=bool(n_experts) and (
                config.get("topk_method", "") == "noaux_tc"
                or config.get("model_type") == "deepseek_v3"
            ),
            first_k_dense=0 if all_dense else first_dense,
            attention_bias=bool(config.get("attention_bias", config.get("model_type") in (
                "qwen2", "qwen2_moe", "qwen2_vl", "qwen2_vl_text"))),
            # Gemma: hidden_activation gelu_pytorch_tanh (None in older
            # configs means the same), (1+w) norms, sqrt(hidden) embeds.
            mlp_act="gelu_tanh" if config.get("model_type") == "gemma" else "silu",
            norm_plus_one=config.get("model_type") == "gemma",
            embed_scale=config.get("model_type") == "gemma",
            qk_norm={"qwen3": "head", "qwen3_moe": "head", "olmoe": "flat"}.get(
                config.get("model_type", ""), ""
            ),
            # HF gates the window: Qwen2-family configs carry sliding_window
            # together with use_sliding_window=false (full causal). Adopt the
            # key only when the gate is on (absent = on, Mistral-style) AND
            # it applies to every layer (max_window_layers partial-SWA is
            # unsupported — full attention is the conservative fallback).
            sliding_window=int(config.get("sliding_window") or 0)
            if config.get("use_sliding_window", True)
            and int(config.get("max_window_layers") or config["num_hidden_layers"])
            >= config["num_hidden_layers"]
            else 0,
            # DeepSeek-V2/V3: MLA signalled by the latent-rank keys.
            attn_type="mla" if config.get("kv_lora_rank") else "gqa",
            q_lora_rank=config.get("q_lora_rank") or 0,
            kv_lora_rank=config.get("kv_lora_rank") or 0,
            qk_nope_head_dim=config.get("qk_nope_head_dim") or 0,
            qk_rope_head_dim=config.get("qk_rope_head_dim") or 0,
            v_head_dim=config.get("v_head_dim") or 0,
            # HF defaults rope_interleave=True for DeepSeek MLA configs, so
            # a missing key means interleaved — matching every real V2/V3
            # checkpoint. save_params now always writes the key; MLA
            # checkpoints exported by THIS repo before the rope fix (no key,
            # weights half-split) load wrong under this default — re-export,
            # or add "rope_interleave": false to their config.json.
            rope_interleave=bool(config.get("rope_interleave", True))
            if config.get("kv_lora_rank")
            else False,
        )


PRESETS: dict[str, ModelConfig] = {
    # Small enough for fast CPU unit tests, large enough to exercise GQA + paging.
    "test-tiny": ModelConfig(
        name="test-tiny", vocab_size=256, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        rope_theta=10000.0, max_position=512, tie_embeddings=True, dtype="float32",
    ),
    # The kernels' geometry at test size: head_dim 64, GQA group 2.
    "test-kernel": ModelConfig(
        name="test-kernel", vocab_size=256, hidden_size=512, num_layers=2,
        num_heads=8, num_kv_heads=4, head_dim=64, intermediate_size=256,
        rope_theta=10000.0, max_position=512, tie_embeddings=True, dtype="float32",
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b", vocab_size=128256, hidden_size=2048, num_layers=16,
        num_heads=32, num_kv_heads=8, head_dim=64, intermediate_size=8192,
        rope_theta=500000.0, tie_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b", vocab_size=128256, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=500000.0, max_position=8192,
    ),
    "llama-3-70b": ModelConfig(
        name="llama-3-70b", vocab_size=128256, hidden_size=8192, num_layers=80,
        num_heads=64, num_kv_heads=8, head_dim=128, intermediate_size=28672,
        rope_theta=500000.0, max_position=8192,
    ),
    # DeepSeek-R1-Distill-Llama-8B: Llama-3.1-8B architecture; distilled
    # weights load via the standard Llama map.
    "deepseek-r1-distill-8b": ModelConfig(
        name="deepseek-r1-distill-8b", vocab_size=128256, hidden_size=4096,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        intermediate_size=14336, rope_theta=500000.0, max_position=131072,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    ),
    # Qwen2.5-7B: Qwen2 family (q/k/v biases, untied head, 1M-theta rope).
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b", vocab_size=152064, hidden_size=3584, num_layers=28,
        num_heads=28, num_kv_heads=4, head_dim=128, intermediate_size=18944,
        rope_theta=1000000.0, max_position=32768, rms_eps=1e-6,
        attention_bias=True,
    ),
    # Qwen3-8B: per-head Q/K RMS norm, untied head, no attention bias.
    "qwen3-8b": ModelConfig(
        name="qwen3-8b", vocab_size=151936, hidden_size=4096, num_layers=36,
        num_heads=32, num_kv_heads=8, head_dim=128, intermediate_size=12288,
        rope_theta=1000000.0, max_position=40960, rms_eps=1e-6,
        qk_norm="head",
    ),
    # MoE test model: 4 experts, top-2.
    "test-tiny-moe": ModelConfig(
        name="test-tiny-moe", vocab_size=256, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        rope_theta=10000.0, max_position=512, tie_embeddings=True, dtype="float32",
        num_experts=4, num_experts_per_token=2, moe_intermediate_size=64,
    ),
    # Tiny V3-true-shape test model: MLA + sigmoid/noaux_tc routing +
    # group-limited top-k + a leading dense layer.
    "test-tiny-v3": ModelConfig(
        name="test-tiny-v3", vocab_size=256, hidden_size=64, num_layers=3,
        num_heads=4, num_kv_heads=4, head_dim=16, intermediate_size=128,
        rope_theta=10000.0, max_position=512, tie_embeddings=True, dtype="float32",
        num_experts=4, num_experts_per_token=2, moe_intermediate_size=32,
        shared_expert_size=32,
        attn_type="mla", q_lora_rank=32, kv_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        rope_interleave=True, moe_scoring="sigmoid", moe_router_bias=True,
        moe_norm_topk=True, moe_routed_scaling=2.5, moe_n_group=2,
        moe_topk_group=1, first_k_dense=1,
    ),
    # OLMoE-1B-7B: the 6.9B-total / 1.3B-active checkpoint shape: 64
    # experts / top-8, no shared expert, softmax routing with top-k renorm,
    # flat Q/K norm, MHA at head_dim 128 (13.8 GB of bf16 weights).
    "olmoe-1b-7b": ModelConfig(
        name="olmoe-1b-7b", vocab_size=50304, hidden_size=2048,
        num_layers=16, num_heads=16, num_kv_heads=16, head_dim=128,
        intermediate_size=1024, rope_theta=10000.0, max_position=4096,
        num_experts=64, num_experts_per_token=8, moe_intermediate_size=1024,
        moe_scoring="softmax", moe_norm_topk=True, qk_norm="flat",
    ),
    # Qwen3-30B-A3B: 128 experts / top-8 MoE with per-head qk-norm (61 GB of
    # bf16 weights).
    "qwen3-30b-a3b": ModelConfig(
        name="qwen3-30b-a3b", vocab_size=151936, hidden_size=2048, num_layers=48,
        num_heads=32, num_kv_heads=4, head_dim=128, intermediate_size=6144,
        rope_theta=1000000.0, max_position=40960, rms_eps=1e-6,
        num_experts=128, num_experts_per_token=8, moe_intermediate_size=768,
        moe_scoring="softmax", moe_norm_topk=True, qk_norm="head",
    ),
    # Mixtral-8x7B: 8 routed experts / top-2, no shared expert.
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=1000000.0, max_position=32768,
        num_experts=8, num_experts_per_token=2, moe_intermediate_size=14336,
    ),
    # Qwen1.5-MoE-A2.7B-class: 14.3B total / 2.7B active: 60 experts /
    # top-4 + a sigmoid-gated shared expert (Qwen2-MoE semantics).
    "qwen1.5-moe-a2.7b": ModelConfig(
        name="qwen1.5-moe-a2.7b", vocab_size=151936, hidden_size=2048,
        num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
        intermediate_size=5632, rope_theta=1000000.0, max_position=8192,
        num_experts=60, num_experts_per_token=4, moe_intermediate_size=1408,
        shared_expert_size=5632, shared_expert_gated=True,
        moe_scoring="softmax", moe_norm_topk=False, attention_bias=True,
    ),
    # DeepSeek-V2-Lite: the 15.7B MoE+MLA checkpoint shape: 64 routed
    # experts / top-6 + 2 shared experts, MLA without q-LoRA, one leading
    # dense layer.
    "deepseek-v2-lite": ModelConfig(
        name="deepseek-v2-lite", vocab_size=102400, hidden_size=2048,
        num_layers=27, num_heads=16, num_kv_heads=16, head_dim=128,
        intermediate_size=10944, rope_theta=10000.0, max_position=163840,
        num_experts=64, num_experts_per_token=6, moe_intermediate_size=1408,
        shared_expert_size=2816,  # n_shared_experts=2
        attn_type="mla", q_lora_rank=0, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_interleave=True, moe_scoring="softmax", moe_norm_topk=False,
        moe_routed_scaling=1.0, first_k_dense=1,
    ),
    # DeepSeek-V3's shape: 256 routed experts / top-8 with MLA (latent KV
    # cache, absorbed up-projections, models/mla.py); its weights need
    # expert parallelism (ROADMAP A8), no single card holds them.
    "deepseek-v3-ep": ModelConfig(
        name="deepseek-v3-ep", vocab_size=129280, hidden_size=7168,
        num_layers=61, num_heads=128, num_kv_heads=128, head_dim=64,
        intermediate_size=18432, rope_theta=10000.0, max_position=163840,
        num_experts=256, num_experts_per_token=8, moe_intermediate_size=2048,
        shared_expert_size=2048,  # n_shared_experts=1
        attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_interleave=True,  # real V3 checkpoints ship interleaved rope dims
        # V3 router: sigmoid scores + aux-free correction bias, 8 groups
        # with the best 4 eligible, renormalized weights scaled 2.5x.
        moe_scoring="sigmoid", moe_router_bias=True, moe_norm_topk=True,
        moe_routed_scaling=2.5, moe_n_group=8, moe_topk_group=4,
        first_k_dense=3,
    ),
    # MLA throughput proxy at 8B-class scale: DeepSeek-V3's per-layer MLA
    # geometry (kv_lora 512 + rope 64 latent cache, absorbed projections)
    # on a 32-layer/4096-hidden dense trunk; no public checkpoint has this
    # exact shape.
    "mla-8b-proxy": ModelConfig(
        name="mla-8b-proxy", vocab_size=128256, hidden_size=4096,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        intermediate_size=14336, rope_theta=500000.0, max_position=8192,
        attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_interleave=True,
    ),
    # MLA test model (tiny): latent cache + absorbed projections.
    "test-tiny-mla": ModelConfig(
        name="test-tiny-mla", vocab_size=256, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=4, head_dim=16, intermediate_size=128,
        rope_theta=10000.0, max_position=512, tie_embeddings=True, dtype="float32",
        attn_type="mla", q_lora_rank=32, kv_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    ),
}
