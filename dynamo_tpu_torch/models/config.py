"""Model architecture config + the presets this slice serves.

A copy of ``dynamo_tpu/models/config.py:ModelConfig`` (same fields, so a
config converts either way with ``dataclasses.asdict``) restricted to the
presets the port runs: the CPU test models (dense GQA and MLA) and the
widths served on the card (two Llama-3 models and the dense-trunk MLA proxy).
``ModelConfig.from_hf`` reads an HF ``config.json`` as the JAX build does.
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
        biases, the DeepSeek MLA dense trunk). A config with MoE layers, a
        sliding window or a vision tower raises ``NotImplementedError``
        naming the field (ROADMAP A6)."""
        if not isinstance(config, dict):
            config = json.loads(pathlib.Path(config).read_text())
        if "vision_config" in config:
            raise NotImplementedError(
                "config field 'vision_config': multimodal checkpoints are not ported to "
                "dynamo_tpu_torch yet (ROADMAP A6)")
        cfg = cls._from_hf_fields(config, name=name)
        for field, value in (("num_experts", cfg.num_experts), ("sliding_window", cfg.sliding_window)):
            if value:
                raise NotImplementedError(
                    f"config field {field!r} = {value}: MoE layers and sliding-window attention are "
                    "not ported to dynamo_tpu_torch yet (ROADMAP A6)")
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
