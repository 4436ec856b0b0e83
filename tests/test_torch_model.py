"""dynamo_tpu_torch model, bridge and runner held against dynamo_tpu (JAX) on the CPU.

The same parameters (the JAX build's init_params, carried over by
bridge.params_from_jax) and the same numpy inputs go through both forwards.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.runner import ModelRunner, StepBatch as JStepBatch
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.models.mla import mla_cache_widths as jmla_cache_widths
from dynamo_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from dynamo_tpu_torch.engine.runner import StepBatch, TorchModelRunner
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import PRESETS


def _jax_params(name):
    return jllama.init_params(JPRESETS[name], 0)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_presets_equal_jax():
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JPRESETS[name])


@pytest.mark.parametrize("feature", [pytest.param(dict(sliding_window=32), id="feature2"),
                                     pytest.param(dict(image_token_id=5), id="feature3"),
                                     pytest.param(dict(video_token_id=6), id="feature4")])
def test_unported_architectures_are_refused(feature):
    cfg = dataclasses.replace(PRESETS["test-tiny"], **feature)
    with pytest.raises(NotImplementedError):
        tllama.init_kv_cache(cfg, 4, 4, device="cpu")


@pytest.mark.parametrize("name", ["test-tiny-mla", "mla-8b-proxy"])
def test_mla_cache_has_the_jax_widths(name):
    """MLA caches the latent (kv_lora_rank) in k_cache and the rope key,
    lane-padded to max(qk_rope_head_dim, 128), in v_cache: the JAX build's
    widths (no array is built on the JAX side)."""
    cfg = PRESETS[name]
    k, v = tllama.init_kv_cache(cfg, 3, 4, device="cpu")
    wk, wv = jmla_cache_widths(JPRESETS[name])
    assert (wk, wv) == (cfg.kv_lora_rank, max(cfg.qk_rope_head_dim, 128))
    assert k.shape == (cfg.num_layers, 3, 4, wk) and v.shape == (cfg.num_layers, 3, 4, wv)
    assert bool((v == 0).all())


def test_bridge_keeps_bf16_bits_and_refuses_quantized_leaves():
    import ml_dtypes

    a = np.random.default_rng(0).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(), a.view(np.uint16))
    # Quantized leaves cross bit for bit, each array in its own dtype (a GGUF
    # import's float32 scale and qbias stay float32).
    rng = np.random.default_rng(1)
    leaf = {"qw4": rng.integers(-128, 128, (2, 4, 3)).astype(np.int8),
            "scale": rng.standard_normal((2, 2, 3)).astype(ml_dtypes.bfloat16),
            "qbias": rng.standard_normal((2, 2, 3)).astype(np.float32)}
    got = params_from_jax({"layers": {"wq": leaf}}, device="cpu")["layers"]["wq"]
    assert {k: v.dtype for k, v in got.items()} == {"qw4": torch.int8, "scale": torch.bfloat16,
                                                      "qbias": torch.float32}
    np.testing.assert_array_equal(got["qw4"].numpy(), leaf["qw4"])
    np.testing.assert_array_equal(got["scale"].view(torch.uint16).numpy(), leaf["scale"].view(np.uint16))
    np.testing.assert_array_equal(got["qbias"].numpy(), leaf["qbias"])


def _step_inputs(cfg, ps, npages):
    """A prefill step (row 1 continues after 8 cached tokens) then a decode step."""
    rng = np.random.default_rng(1)
    b, t = 2, 8
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    starts = [0, 8]
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.stack([np.arange(s, s + t) for s in starts]).astype(np.int32)
    pos[0, 6:] = 0  # row 0 has 6 real tokens, then padding (null-page slots)
    slots = np.where(pos > 0, tables[np.arange(b)[:, None], pos // ps] * ps + pos % ps, 0).astype(np.int32)
    slots[0, 0] = tables[0, 0] * ps  # position 0 is real in row 0
    last = np.array([5, 7], np.int32)
    dec_tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    dec_pos = np.array([[6], [16]], np.int32)
    dec_slots = (tables[np.arange(b)[:, None], dec_pos // ps] * ps + dec_pos % ps).astype(np.int32)
    return [(tokens, pos, tables, slots, last), (dec_tok, dec_pos, tables, dec_slots, np.zeros(b, np.int32))]


@pytest.mark.parametrize("name", ["test-tiny", "test-kernel", "test-tiny-mla"])
def test_forward_matches_jax(name):
    """Logits of a prefill step and a decode step, and both caches after
    them. f32 on both sides over two layers: 1e-4 absolute on O(1) logits
    covers the different summation orders; the null page (padding writes)
    is excluded from the cache comparison (for MLA the zero rope tail is
    compared too)."""
    jcfg, cfg = JPRESETS[name], PRESETS[name]
    jparams = _jax_params(name)
    params = params_from_jax(_numpy_tree(jparams), device="cpu")
    ps, npages = 4, 16
    jk, jv = jllama.init_kv_cache(jcfg, npages, ps)
    tk, tv = tllama.init_kv_cache(cfg, npages, ps, device="cpu")
    for tokens, pos, tables, slots, last in _step_inputs(cfg, ps, npages):
        jlogits, jk, jv = jllama.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jk, jv,
                                         jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(last),
                                         attn_impl="reference")
        tlogits, tk, tv = tllama.forward(params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), tk, tv,
                                         torch.from_numpy(tables), torch.from_numpy(slots), torch.from_numpy(last))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], rtol=0, atol=1e-5)


def _batch(cls, cfg):
    rng = np.random.default_rng(2)
    b, t, ps = 3, 5, 4
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    slots = (tables[np.arange(b)[:, None], pos // ps] * ps + pos % ps).astype(np.int32)
    return cls(
        tokens=tokens, positions=pos, block_tables=tables, slot_mapping=slots,
        last_token_index=np.full(b, t - 1, np.int32),
        temperature=np.zeros(b, np.float32), top_k=np.zeros(b, np.int32), top_p=np.ones(b, np.float32),
        seeds=np.zeros(b, np.uint32), sample_steps=np.zeros(b, np.int32),
        freq_pen=np.zeros(b, np.float32), pres_pen=np.zeros(b, np.float32),
        pos_limit=np.full(b, 64, np.int32), history=np.full((b, 1), -1, np.int32),
    )


def test_runner_step_tokens_match_jax():
    """Greedy tokens of a runner step, bitwise, with logprobs within 1e-4."""
    name = "test-tiny"
    jparams = _jax_params(name)
    jr = ModelRunner(JPRESETS[name], jparams, num_pages=16, page_size=4, max_batch_size=4,
                     prefill_bucket=8, attn_impl="reference")
    tr = TorchModelRunner(PRESETS[name], params_from_jax(_numpy_tree(jparams), device="cpu"), num_pages=16, page_size=4,
                          max_batch_size=4, prefill_bucket=8, device="cpu")
    jtok, jlp = jr.step(_batch(JStepBatch, PRESETS[name]), lp_k=3)
    ttok, tlp = tr.step(_batch(StepBatch, PRESETS[name]), lp_k=3)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tlp["top_ids"], jlp["top_ids"])
    np.testing.assert_allclose(tlp["logprob"], jlp["logprob"], rtol=0, atol=1e-4)
    assert tr.last_attn_dispatch == ("prefill", "plain")  # CPU tensors take the kernels' plain versions
    with pytest.raises(ValueError):  # non-contiguous rows are refused before the device step
        bad = _batch(StepBatch, PRESETS[name])
        bad.positions[0, 2] = 9
        tr.step(bad)
