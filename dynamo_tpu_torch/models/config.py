"""Model architecture config + the presets this slice serves.

A copy of ``dynamo_tpu/models/config.py:ModelConfig`` (same fields, so a
config converts either way with ``dataclasses.asdict``) restricted to the
presets the port runs: the CPU test models (dense GQA and MLA) and the
widths served on the card (two Llama-3 models and the dense-trunk MLA proxy).
"""

from __future__ import annotations

import dataclasses


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
