"""The port's checkpoint loading on the CPU (the port's counterpart of
``tests/test_loader.py`` and ``tests/test_golden.py``).

The hand-written safetensors reader is held against ``safetensors`` itself;
the port's ``load_params`` against ``bridge.params_from_jax`` of the JAX
loader on the same checkpoints (written by JAX's ``save_params``), bit for
bit; the port's ``save_params`` output against JAX's loader; its
``ModelConfig.from_hf`` against JAX's field by field; and its forward on a
loaded HF checkpoint against HF transformers' logits.
"""

import ast
import dataclasses
import json
import pathlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.models import llama, loader
from dynamo_tpu_torch.models.config import ModelConfig

REPO = pathlib.Path(__file__).resolve().parents[1]


def _leaves(tree, path=""):
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)]


def assert_bitwise(got: dict, want: dict) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), k


# -- the safetensors format, by hand ---------------------------------------------


def test_reader_equals_safetensors_on_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(7, generator=gen).half(),
        "bf16": torch.randn(2, 3, 4, generator=gen).bfloat16(),
        "i64": torch.arange(6, dtype=torch.int64).view(2, 3),
        "i32": torch.arange(-3, 3, dtype=torch.int32),
        "u8": torch.arange(10, dtype=torch.uint8),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    f = loader.SafetensorsFile(tmp_path / "a.safetensors")
    assert f.metadata == {"format": "pt"} and sorted(f.keys()) == sorted(tensors)
    with safe_open(str(tmp_path / "a.safetensors"), framework="pt") as ref:
        for name in tensors:
            want = ref.get_tensor(name)
            got = f.read(name)
            assert got.dtype == want.dtype and f.shape(name) == tuple(want.shape)
            assert torch.equal(got, want), name
    # The writer's output, read back by safetensors.
    loader.write_safetensors(tmp_path / "b.safetensors", list(tensors.items()), metadata={"k": "v"})
    with safe_open(str(tmp_path / "b.safetensors"), framework="pt") as ref:
        assert ref.metadata() == {"k": "v"}
        for name, t in tensors.items():
            assert torch.equal(ref.get_tensor(name), t), name


def test_reader_refuses_a_truncated_file(tmp_path):
    save_file({"x": torch.ones(64)}, str(tmp_path / "x.safetensors"))
    raw = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "x.safetensors").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="spans bytes"):
        loader.SafetensorsFile(tmp_path / "x.safetensors")


def test_sharded_index_equals_safetensors(tmp_path):
    gen = torch.Generator().manual_seed(1)
    shards = {"model-00001-of-00002.safetensors": {"a": torch.randn(4, 4, generator=gen).bfloat16()},
              "model-00002-of-00002.safetensors": {"b": torch.randn(3, generator=gen), "c": torch.ones(2).half()}}
    weight_map = {}
    for fname, ts in shards.items():
        save_file(ts, str(tmp_path / fname))
        weight_map.update({k: fname for k in ts})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    idx = loader.CheckpointIndex(tmp_path)
    assert idx.keys() == ["a", "b", "c"] and "b" in idx and "z" not in idx
    for fname, ts in shards.items():
        with safe_open(str(tmp_path / fname), framework="pt") as ref:
            for k in ts:
                assert idx.shape(k) == tuple(ref.get_tensor(k).shape)
                assert torch.equal(idx.read(k), ref.get_tensor(k))


# -- load_params against the JAX loader ----------------------------------------------


def _random_jax_params(cfg, seed):
    """JAX init's tree with every leaf redrawn from a seeded normal (norm
    weights and biases are not 1 and 0), in the config's dtype."""
    rng = np.random.default_rng(seed)
    dt = ml_dtypes.bfloat16 if cfg.dtype == "bfloat16" else np.float32
    return jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(dt), jllama.init_params(cfg, 0))


CHECKPOINTS = {
    "llama-dense": dataclasses.replace(JPRESETS["test-tiny"], dtype="bfloat16"),
    "llama3-rope-scaling": dataclasses.replace(
        JPRESETS["test-tiny"], rope_theta=500000.0, dtype="bfloat16",
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}),
    "qwen2-bias": dataclasses.replace(JPRESETS["test-tiny"], attention_bias=True),
    "untied-lm-head": dataclasses.replace(JPRESETS["test-tiny"], tie_embeddings=False, dtype="bfloat16"),
    "mla-dense-trunk": dataclasses.replace(JPRESETS["test-tiny-mla"], rope_interleave=True, dtype="bfloat16"),
}


@pytest.mark.parametrize("kind", list(CHECKPOINTS))
def test_load_params_equals_the_jax_loader_bitwise(kind, tmp_path):
    """A checkpoint written by JAX's save_params: the port's load_params
    equals bridge.params_from_jax(JAX load_params), every leaf bit for bit;
    and the port's save_params of those parameters loads back in JAX's
    load_params (and the port's) to the same bits."""
    jcfg = CHECKPOINTS[kind]
    jparams = _random_jax_params(jcfg, seed=len(kind))
    jloader.save_params(tmp_path / "jax", jcfg, jparams)
    cfg = ModelConfig.from_hf(tmp_path / "jax" / "config.json")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JModelConfig.from_hf(tmp_path / "jax" / "config.json"))
    got = loader.load_params(tmp_path / "jax", cfg, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jloader.load_params(tmp_path / "jax", JModelConfig.from_hf(
        tmp_path / "jax" / "config.json"))), device="cpu")
    assert_bitwise(got, want)
    # The reverse: the port writes (in shards), both loaders read. (from_hf
    # reads no dtype, so the config written is the one the JAX writer had.)
    files = loader.save_params(tmp_path / "port", ModelConfig(**dataclasses.asdict(jcfg)), got,
                               max_shard_bytes=16384)
    assert len(files) > 1
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == json.loads(
        (tmp_path / "jax" / "config.json").read_text())
    assert_bitwise(loader.load_params(tmp_path / "port", cfg, device="cpu"), got)
    back = jloader.load_params(tmp_path / "port", JModelConfig.from_hf(tmp_path / "port" / "config.json"))
    assert_bitwise(params_from_jax(jax.tree.map(np.asarray, back), device="cpu"), got)


def test_load_model_casts_as_the_jax_loader_does(tmp_path):
    """An f32 checkpoint loaded as bf16 rounds as JAX's cast does, and
    load_model names the config after the directory."""
    jcfg = JPRESETS["test-tiny"]
    jloader.save_params(tmp_path / "tiny", jcfg, _random_jax_params(jcfg, 3))
    cfg, got = loader.load_model(tmp_path / "tiny", device="cpu", dtype=torch.bfloat16)
    assert cfg.name == "tiny" and cfg.dtype == "bfloat16"
    _jcfg, want = jloader.load_model(tmp_path / "tiny", dtype="bfloat16")
    assert_bitwise(got, params_from_jax(jax.tree.map(np.asarray, want), device="cpu"))


def test_strict_refuses_dropped_tensors_and_renamed_index(tmp_path):
    cfg = dataclasses.replace(JPRESETS["test-tiny"], name="t")
    params = params_from_jax(jax.tree.map(np.asarray, _random_jax_params(cfg, 4)), device="cpu")
    loader.save_params(tmp_path, ModelConfig(**dataclasses.asdict(cfg)), params)
    save_file({"model.layers.0.mlp.extra.weight": torch.ones(3)}, str(tmp_path / "extra.safetensors"))
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    index["weight_map"]["model.layers.0.mlp.extra.weight"] = "extra.safetensors"
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match="model.layers.0.mlp.extra.weight"):
        loader.load_params(tmp_path, pcfg, device="cpu")
    assert_bitwise(loader.load_params(tmp_path, pcfg, device="cpu", strict=False), params)
    # A VLM checkpoint's LM half (post-refactor names) through _RenamedIndex:
    # the tower's tensors are hidden from the strict check.
    vlm = tmp_path / "vlm"
    vlm.mkdir()
    idx = loader.CheckpointIndex(tmp_path)
    renamed = {("model.language_model." + k[len("model."):] if k.startswith("model.") else k): idx.read(k)
               for k in idx.keys() if "extra" not in k}
    renamed["model.vision_tower.patch.weight"] = torch.ones(2)
    save_file(renamed, str(vlm / "model.safetensors"))
    got = loader.load_params(vlm, pcfg, device="cpu", index=loader._RenamedIndex(loader.CheckpointIndex(vlm)))
    assert_bitwise(got, params)


@pytest.mark.parametrize("config,field", [
    pytest.param({"sliding_window": 4096, "model_type": "mistral"}, "sliding_window",
                 id="config1-sliding_window"),
    pytest.param({"vision_config": {"hidden_size": 32}, "text_config": {}}, "vision_config",
                 id="config2-vision_config"),
])
def test_unported_configs_are_refused_by_name(config, field):
    base = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2, "vocab_size": 256,
            "intermediate_size": 128}
    with pytest.raises(NotImplementedError, match=f"{field}.*A6"):
        ModelConfig.from_hf({**base, **config})


HF_CONFIGS = {
    "llama3": {"model_type": "llama", "hidden_size": 2048, "num_attention_heads": 32, "num_key_value_heads": 8,
               "num_hidden_layers": 16, "vocab_size": 128256, "intermediate_size": 8192, "rope_theta": 500000.0,
               "tie_word_embeddings": True, "max_position_embeddings": 131072,
               "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}},
    "qwen2": {"model_type": "qwen2", "hidden_size": 896, "num_attention_heads": 14, "num_key_value_heads": 2,
              "num_hidden_layers": 24, "vocab_size": 151936, "intermediate_size": 4864, "sliding_window": 32768,
              "use_sliding_window": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6},
    "deepseek-dense": {"model_type": "deepseek_v3", "hidden_size": 64, "num_attention_heads": 4,
                       "num_hidden_layers": 2, "vocab_size": 256, "intermediate_size": 128, "kv_lora_rank": 24,
                       "q_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
                       "first_k_dense_replace": 2, "n_routed_experts": 8},
    "qwen3": {"model_type": "qwen3", "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
              "vocab_size": 256, "intermediate_size": 128, "head_dim": 32},
    "gemma": {"model_type": "gemma", "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
              "vocab_size": 256, "intermediate_size": 128},
    "mixtral": {"model_type": "mixtral", "hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
                "num_hidden_layers": 32, "vocab_size": 32000, "intermediate_size": 14336, "num_local_experts": 8,
                "num_experts_per_tok": 2, "rope_theta": 1000000.0, "sliding_window": None},
    "qwen2-moe": {"model_type": "qwen2_moe", "hidden_size": 2048, "num_attention_heads": 16,
                  "num_key_value_heads": 16, "num_hidden_layers": 24, "vocab_size": 151936,
                  "intermediate_size": 5632, "num_experts": 60, "num_experts_per_tok": 4,
                  "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632, "norm_topk_prob": False,
                  "sliding_window": 32768, "use_sliding_window": False, "rope_theta": 1000000.0},
    "olmoe": {"model_type": "olmoe", "hidden_size": 2048, "num_attention_heads": 16, "num_key_value_heads": 16,
              "num_hidden_layers": 16, "vocab_size": 50304, "intermediate_size": 1024, "num_experts": 64,
              "num_experts_per_tok": 8, "norm_topk_prob": False, "max_position_embeddings": 4096},
    "qwen3-moe": {"model_type": "qwen3_moe", "hidden_size": 2048, "num_attention_heads": 32,
                  "num_key_value_heads": 4, "num_hidden_layers": 48, "vocab_size": 151936, "head_dim": 128,
                  "intermediate_size": 6144, "num_experts": 128, "num_experts_per_tok": 8,
                  "moe_intermediate_size": 768, "norm_topk_prob": True, "rms_norm_eps": 1e-6},
    "deepseek-v2": {"model_type": "deepseek_v2", "hidden_size": 2048, "num_attention_heads": 16,
                    "num_hidden_layers": 27, "vocab_size": 102400, "intermediate_size": 10944, "kv_lora_rank": 512,
                    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
                    "first_k_dense_replace": 1, "n_routed_experts": 64, "n_shared_experts": 2,
                    "num_experts_per_tok": 6, "moe_intermediate_size": 1408, "topk_method": "greedy",
                    "norm_topk_prob": False, "routed_scaling_factor": 1.0},
    "deepseek-v3": {"model_type": "deepseek_v3", "hidden_size": 7168, "num_attention_heads": 128,
                    "num_hidden_layers": 61, "vocab_size": 129280, "intermediate_size": 18432, "kv_lora_rank": 512,
                    "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
                    "first_k_dense_replace": 3, "n_routed_experts": 256, "n_shared_experts": 1,
                    "num_experts_per_tok": 8, "moe_intermediate_size": 2048, "n_group": 8, "topk_group": 4,
                    "routed_scaling_factor": 2.5},
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_from_hf_equals_jax_field_by_field(name):
    assert dataclasses.asdict(ModelConfig.from_hf(HF_CONFIGS[name], name=name)) == dataclasses.asdict(
        JModelConfig.from_hf(HF_CONFIGS[name], name=name))


def test_rope_permutations_equal_jax():
    for args in ((4, 24, 8), (1, 88, 64), (2, 16, 16)):
        assert np.array_equal(loader.rope_load_perm(*args), jloader.rope_load_perm(*args))
        assert np.array_equal(loader.rope_save_perm(*args), jloader.rope_save_perm(*args))


# -- HF goldens ----------------------------------------------------------------------

PROMPT = [3, 17, 42, 99, 7, 123, 200, 5]


def _port_forward(path, extra):
    """The port's forward on a loaded HF checkpoint (f32): prefill, then a
    decode step per token of ``extra``; logits after each."""
    cfg, params = loader.load_model(path, device="cpu", dtype=torch.float32)
    ps = 8
    kc, vc = llama.init_kv_cache(cfg, 6, ps, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)

    def slots(pos):
        return torch.tensor([[(1 + p // ps) * ps + p % ps for p in pos]], dtype=torch.int32)

    t = len(PROMPT)
    logits, _, _ = llama.forward(params, cfg, torch.tensor([PROMPT], dtype=torch.int32),
                                 torch.arange(t, dtype=torch.int32)[None], kc, vc, tables, slots(range(t)),
                                 torch.tensor([t - 1], dtype=torch.int32))
    outs = [logits[0]]
    for i, tok in enumerate(extra):
        logits, _, _ = llama.forward(params, cfg, torch.tensor([[tok]], dtype=torch.int32),
                                     torch.tensor([[t + i]], dtype=torch.int32), kc, vc, tables, slots([t + i]),
                                     torch.zeros(1, dtype=torch.int32))
        outs.append(logits[0])
    return outs


def _hf_model(family: str):
    """A tiny seeded HF model of ``family``, built by ``transformers`` itself:
    the configurations JAX's ``tests/test_golden.py`` pins, with random norm
    weights where a norm is the point and a random DeepSeek-V3 correction
    bias (so noaux_tc selection is load-bearing)."""
    import transformers as tf
    from transformers.models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM
    from transformers.models.deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM

    common = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  tie_word_embeddings=False)
    mla = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=4,
               q_lora_rank=32, kv_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
               tie_word_embeddings=False, rope_scaling=None, attention_bias=False)
    seed, build = {
        "llama-gqa": (0, lambda: tf.LlamaForCausalLM(tf.LlamaConfig(
            intermediate_size=128, head_dim=16, rope_theta=10000.0, **common))),
        "qwen2-bias": (2, lambda: tf.Qwen2ForCausalLM(tf.Qwen2Config(
            intermediate_size=128, rope_theta=1000000.0, **common))),
        "qwen3": (8, lambda: tf.Qwen3ForCausalLM(tf.Qwen3Config(
            intermediate_size=128, head_dim=16, rope_theta=1000000.0, **common))),
        "gemma": (0, lambda: tf.GemmaForCausalLM(tf.GemmaConfig(
            **{**common, "tie_word_embeddings": True}, intermediate_size=128, head_dim=16, rope_theta=10000.0,
            hidden_activation="gelu_pytorch_tanh"))),
        "deepseek-mla-dense": (4, lambda: DeepseekV3ForCausalLM(DeepseekV3Config(
            num_hidden_layers=2, first_k_dense_replace=2, rope_interleave=True, **mla))),
        "mixtral": (3, lambda: tf.MixtralForCausalLM(tf.MixtralConfig(
            intermediate_size=96, num_local_experts=4, num_experts_per_tok=2, **common))),
        "qwen2-moe-shared": (6, lambda: tf.Qwen2MoeForCausalLM(tf.Qwen2MoeConfig(
            intermediate_size=128, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
            shared_expert_intermediate_size=48, norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
            **common))),
        "deepseek-v3-true-shape": (5, lambda: DeepseekV3ForCausalLM(DeepseekV3Config(
            num_hidden_layers=3, first_k_dense_replace=1, n_group=2, topk_group=1, topk_method="noaux_tc",
            routed_scaling_factor=2.5, norm_topk_prob=True, rope_interleave=True, **mla))),
        "deepseek-v2-group-limited": (7, lambda: DeepseekV2ForCausalLM(DeepseekV2Config(
            num_hidden_layers=3, first_k_dense_replace=1, n_group=2, topk_group=1,
            topk_method="group_limited_greedy", routed_scaling_factor=1.0, norm_topk_prob=False, **mla))),
        "olmoe-flat-qk-norm": (9, lambda: tf.OlmoeForCausalLM(tf.OlmoeConfig(
            intermediate_size=96, num_experts=8, num_experts_per_tok=2, norm_topk_prob=False, **common))),
    }[family]
    torch.manual_seed(seed)
    model = build().eval().float()
    with torch.no_grad():
        for layer in model.model.layers:
            if family in ("qwen3", "olmoe-flat-qk-norm"):
                layer.self_attn.q_norm.weight.uniform_(0.5, 1.5)
                layer.self_attn.k_norm.weight.uniform_(0.5, 1.5)
            if family == "gemma":
                layer.input_layernorm.weight.uniform_(-0.5, 0.5)
                layer.post_attention_layernorm.weight.uniform_(-0.5, 0.5)
            if family == "deepseek-v3-true-shape" and hasattr(layer.mlp, "gate"):
                layer.mlp.gate.e_score_correction_bias.uniform_(-0.2, 0.2)
    return model


GOLDEN_FAMILIES = ["llama-gqa", "qwen2-bias", "qwen3", "gemma", "deepseek-mla-dense", "mixtral", "qwen2-moe-shared",
                   "deepseek-v3-true-shape", "deepseek-v2-group-limited", "olmoe-flat-qk-norm"]


@pytest.mark.parametrize("family", GOLDEN_FAMILIES)
def test_golden_logits_match_hf_transformers(family, tmp_path):
    """A tiny seeded HF model saved by HF itself (its safetensors writer, its
    names), loaded by the port: prefill and two decode steps' logits equal
    HF's within atol 2e-3, rtol 1e-3 (f32 both sides; the attention and
    matmul orders differ), as tests/test_golden.py holds the JAX build. The
    MoE families run the dropless dispatch (the grouped product's plain
    version on the CPU) against HF's per-expert loops."""
    model = _hf_model(family)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    extra = [11, 29]
    with torch.no_grad():
        hf = model(torch.tensor([PROMPT + extra])).logits[0].float()
    ours = _port_forward(tmp_path, extra)
    t = len(PROMPT)
    for step, pos in enumerate([t - 1, t, t + 1]):
        np.testing.assert_allclose(ours[step].numpy(), hf[pos].numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("family", ["mixtral", "qwen2-moe-shared", "olmoe-flat-qk-norm", "deepseek-v3-true-shape"])
def test_moe_checkpoints_load_bitwise_the_jax_loader_and_round_trip(family, tmp_path):
    """An HF-saved MoE checkpoint (Mixtral's ``block_sparse_moe`` names,
    Qwen2-MoE's gated shared expert, OLMoE, DeepSeek-V3's f32 correction
    bias and its dense_layers/layers split): the port's load_params equals
    bridge.params_from_jax(JAX load_params) bit for bit; the port's
    save_params writes JAX's config.json, and both loaders read it back to
    the same bits."""
    _hf_model(family).save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    cfg = ModelConfig.from_hf(tmp_path / "hf" / "config.json")
    jcfg = JModelConfig.from_hf(tmp_path / "hf" / "config.json")
    assert cfg.is_moe and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = loader.load_params(tmp_path / "hf", cfg, device="cpu")
    jparams = jax.tree.map(np.asarray, jloader.load_params(tmp_path / "hf", jcfg))
    assert_bitwise(got, params_from_jax(jparams, device="cpu"))
    if cfg.moe_router_bias:
        assert got["layers"]["router_bias"].dtype == torch.float32 and "dense_layers" in got
    loader.save_params(tmp_path / "port", cfg, got, max_shard_bytes=65536)
    jloader.save_params(tmp_path / "jax", jcfg, jparams)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == json.loads(
        (tmp_path / "jax" / "config.json").read_text())
    assert_bitwise(loader.load_params(tmp_path / "port", cfg, device="cpu"), got)
    back = jloader.load_params(tmp_path / "port", JModelConfig.from_hf(tmp_path / "port" / "config.json"))
    assert_bitwise(params_from_jax(jax.tree.map(np.asarray, back), device="cpu"), got)


def test_quantized_and_gguf_moe_are_refused_by_name(tmp_path):
    """MoE serves at bf16 only: ``--quantize`` on a MoE model (a preset's
    direct quantized init, or quantizing loaded expert leaves, which would
    make 4-D leaves no kernel takes) and GGUF MoE import and export are
    refused by name, naming ROADMAP B6's quantized expert forms."""
    import asyncio

    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.models import gguf
    from dynamo_tpu_torch.models.quant import quantize_params

    cfg = ModelConfig(**dataclasses.asdict(JPRESETS["test-tiny-moe"]))
    params = llama.init_params(cfg, 0, device="cpu")
    for mode in ("int8", "int4"):
        with pytest.raises(NotImplementedError, match=f"--quantize {mode}.*MoE.*B6"):
            asyncio.run(launch.build_engine_service("test-tiny-moe", device="cpu", quantize=mode))
        with pytest.raises(NotImplementedError, match="MoE.*B6"):
            quantize_params(params, mode=mode)
    with pytest.raises(NotImplementedError, match="MoE GGUF.*B6"):
        gguf.load_gguf_params(tmp_path / "unused.gguf", cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE GGUF.*B6"):
        gguf.save_params_gguf(tmp_path / "moe.gguf", cfg, params)
    assert not (tmp_path / "moe.gguf").exists()


# -- guards ----------------------------------------------------------------------------


def test_port_and_smoke_import_no_safetensors_jax_or_reference():
    """Static: no module of the port, nor chip_smoke.py, imports safetensors,
    jax or dynamo_tpu (the guard test checks the port's imports at run time)."""
    files = [REPO / "chip_smoke.py", *sorted((REPO / "dynamo_tpu_torch").rglob("*.py"))]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            bad += [f"{f.name}: {n}" for n in names if n.split(".")[0] in ("safetensors", "jax", "dynamo_tpu")]
    assert not bad


def test_loader_defaults_to_the_card_and_refuses_without_one(monkeypatch, tmp_path):
    cfg = ModelConfig(**dataclasses.asdict(JPRESETS["test-tiny"]))
    loader.save_params(tmp_path, cfg, llama.init_params(cfg, 0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_params(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_model(tmp_path)
