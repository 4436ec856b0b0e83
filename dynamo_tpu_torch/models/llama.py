"""Llama-family decoder, dense trunk with GQA or MLA attention (counterpart
of ``dynamo_tpu/models/llama.py``).

Parameters are a plain dict of tensors with **layers stacked on a leading
axis** and every projection stored ``[in, out]`` (``x @ W``), exactly the
JAX pytree's layout, so ``bridge.params_from_jax`` needs no transposes. A
projection may be a quantized leaf (``models/quant.py``): every projection
and an untied head go through ``quant_matmul``. The paged KV cache is ``[L, num_pages, page_size, n_kv * head_dim]`` (MLA: latents
in ``k_cache``, lane-padded rope keys in ``v_cache``, ``models/mla.py``); the
forward addresses it flat (``[L * pages, ps, W]``) with per-layer page
offsets and updates it **in place** before attention.

MoE, ring attention, multimodal inputs and sliding window raise
``NotImplementedError`` in this port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.mla import init_mla_params, mla_attention, mla_cache_widths
from dynamo_tpu_torch.models.quant import quant_matmul as _qmm
from dynamo_tpu_torch.models.quant import take_layer
from dynamo_tpu_torch.ops.attention import paged_attention, paged_attention_reference, write_kv
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.ops.paged_mla import walk_facts
from dynamo_tpu_torch.ops.rope import apply_rope, rope_attention_factor, rope_frequencies

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architecture features the port does not take yet."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported to dynamo_tpu_torch yet")
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(f"attention type {cfg.attn_type!r} is not ported")
    if cfg.sliding_window > 0:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if cfg.image_token_id is not None or cfg.video_token_id is not None or cfg.mrope_section:
        raise NotImplementedError("multimodal inputs are not ported yet")


def build_params(cfg: ModelConfig, weight, const) -> Params:
    """The parameter tree of ``cfg`` in the JAX build's layout and shapes:
    ``weight(name, shape, fan_in)`` makes each weight leaf (its values, or a
    quantized leaf, ``models/quant.py``), ``const(shape, value)`` each norm
    (1) and bias (0); leaves are made in a fixed order."""
    check_supported(cfg)
    d, q, kv, f, nl = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size, cfg.num_layers
    layers = {
        "attn_norm": const((nl, d), 1.0),
        "mlp_norm": const((nl, d), 1.0),
    }
    if cfg.qk_norm:
        qn = cfg.head_dim if cfg.qk_norm == "head" else q
        kn = cfg.head_dim if cfg.qk_norm == "head" else kv
        layers["q_norm"] = const((nl, qn), 1.0)
        layers["k_norm"] = const((nl, kn), 1.0)
    if cfg.attn_type == "mla":
        layers.update(init_mla_params(cfg, weight, const, nl))
    else:
        layers.update({
            "wq": weight("wq", (nl, d, q), d),
            "wk": weight("wk", (nl, d, kv), d),
            "wv": weight("wv", (nl, d, kv), d),
            "wo": weight("wo", (nl, q, d), q),
        })
    layers.update({
        "w_gate": weight("w_gate", (nl, d, f), d),
        "w_up": weight("w_up", (nl, d, f), d),
        "w_down": weight("w_down", (nl, f, d), f),
    })
    if cfg.attention_bias:
        layers.update({"bq": const((nl, q), 0.0), "bk": const((nl, kv), 0.0), "bv": const((nl, kv), 0.0)})
    params: Params = {
        "embed": weight("embed", (cfg.vocab_size, d), d),
        "norm_f": const((d,), 1.0),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = weight("lm_head", (d, cfg.vocab_size), d)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *, device: str | torch.device = "cuda") -> Params:
    """Random-init parameters from a seeded ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU): the JAX build's shapes and
    scales (normal * fan_in**-0.5, norms at 1, biases at 0). The values
    differ from the JAX build's (different RNG)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def weight(name, shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * fan_in**-0.5).to(dt)

    return build_params(cfg, weight, lambda shape, value: torch.full(shape, value, dtype=dt, device=dev))


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int, dtype: torch.dtype | None = None,
                  *, device: str | torch.device = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the paged KV cache on ``device`` (the card unless the caller
    asks for the CPU): two zeroed [L, num_pages, page_size, W] tensors, W =
    n_kv * hd for GQA; for MLA the latent and the padded rope widths
    (``mla_cache_widths``)."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = dtype or param_dtype(cfg)
    if cfg.attn_type == "mla":
        wk, wv = mla_cache_widths(cfg)
    else:
        wk = wv = cfg.num_kv_heads * cfg.head_dim
    geom = (cfg.num_layers, num_pages, page_size)
    return torch.zeros((*geom, wk), dtype=dt, device=device), torch.zeros((*geom, wv), dtype=dt, device=device)


def _mlp_dense(lp: dict, li: int, x: torch.Tensor, act: str) -> torch.Tensor:
    gp = _qmm(x, take_layer(lp["w_gate"], li))
    gate = F.gelu(gp, approximate="tanh") if act == "gelu_tanh" else F.silu(gp)
    return _qmm(gate * _qmm(x, take_layer(lp["w_up"], li)), take_layer(lp["w_down"], li))


def _head_logits(x: torch.Tensor, head) -> torch.Tensor:
    """``x [N, D] @ head [D, vocab]`` with f32 output, operands in their own
    dtype (no f32 copy of the embedding matrix): cuBLAS's bf16 GEMM with f32
    output on the card (the CPU has no such GEMM, so it upcasts there); a
    quantized head through ``quant_matmul``, its int8 scale applied to the
    f32 output as in the JAX build."""
    return _qmm(x, head, out_dtype=torch.float32)


def rope_table(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """The model's rope inverse frequencies ``f32[rope_dim // 2]`` on
    ``device`` (MLA: its rope lanes). A caller that runs many steps builds it
    once and passes it to :func:`forward`: building it copies from the host."""
    rope_dim = cfg.qk_rope_head_dim if cfg.attn_type == "mla" else cfg.head_dim
    return torch.from_numpy(rope_frequencies(rope_dim, theta=cfg.rope_theta, scaling=cfg.rope_scaling)).to(device)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # i32[B, T]
    positions: torch.Tensor,  # i32[B, T]
    k_cache: torch.Tensor,  # [L, num_pages, page_size, W]; updated in place
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_per_seq]
    slot_mapping: torch.Tensor,  # i32[B, T]
    last_token_index: torch.Tensor,  # i32[B] index in [0,T) of each row's last real token
    *,
    logit_indices: torch.Tensor | None = None,  # i32[B, V] token columns to score
    contiguous_positions: bool = True,
    attn_impl: str | None = None,  # None: kernel dispatch; "reference": gather formulation
    inv_freq: torch.Tensor | None = None,  # rope_table(cfg, device); built here when None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward step. Returns (logits f32[B, vocab] — or f32[B, V, vocab]
    with ``logit_indices`` — , k_cache, v_cache); the caches are the same
    tensors, written in place. ``attn_impl="reference"`` runs attention as
    ``paged_attention_reference``, or MLA's gather formulation (the JAX
    build's ``attn_impl`` switch). With ``inv_freq`` given the step copies
    nothing from the host, so it can be captured in a CUDA graph."""
    if attn_impl not in (None, "reference"):
        raise ValueError(f"unknown attn_impl {attn_impl!r} (want None or 'reference')")
    check_supported(cfg)
    b, t = tokens.shape
    nl, npages, ps, w = k_cache.shape
    dev = tokens.device
    mla = cfg.attn_type == "mla"
    if inv_freq is None:
        inv_freq = rope_table(cfg, dev)
    attn_mscale = rope_attention_factor(cfg.rope_scaling) ** 2
    # Ids past the vocabulary read its last row, as the JAX build's clamped
    # gather does (the byte tokenizer's specials on the 256-token test models).
    x = params["embed"][tokens.long().clamp(0, cfg.vocab_size - 1)]  # [B, T, D]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    # The stacked cache is addressed flat ([L*pages, ps, W]); layer li's
    # pages sit at offset li*pages. Offset tables and slots for every layer
    # are built once per step.
    kf = k_cache.view(nl * npages, ps, w)
    vf = v_cache.view(nl * npages, ps, v_cache.shape[3])
    layer_ids = torch.arange(nl, device=dev, dtype=torch.int32)
    tables_all = (block_tables[None] + (layer_ids * npages)[:, None, None]).contiguous()
    slots_all = slot_mapping.long()[None] + (layer_ids.long() * (npages * ps))[:, None, None]
    # Where each row's MLA walk ends depends on the positions only: one
    # reduction per step, shared by every layer's kernel launch.
    walk = walk_facts(positions) if mla and attn_impl is None and t > 1 else None
    lp = params["layers"]
    for li in range(nl):
        h = rms_norm(x, lp["attn_norm"][li], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
        if mla:
            attn_out, _, _ = mla_attention(
                {k: take_layer(v, li) for k, v in lp.items()}, cfg, h, positions, kf, vf, tables_all[li], slots_all[li],
                inv_freq, attn_mscale=attn_mscale, impl=attn_impl, walk=walk,
            )
            x = x + attn_out
            h2 = rms_norm(x, lp["mlp_norm"][li], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
            x = x + _mlp_dense(lp, li, h2, cfg.mlp_act)
            continue
        qp, kp, vp = (_qmm(h, take_layer(lp[name], li)) for name in ("wq", "wk", "wv"))
        if cfg.attention_bias:
            qp, kp, vp = qp + lp["bq"][li], kp + lp["bk"][li], vp + lp["bv"][li]
        if cfg.qk_norm == "flat":
            qp = rms_norm(qp, lp["q_norm"][li], eps=cfg.rms_eps)
            kp = rms_norm(kp, lp["k_norm"][li], eps=cfg.rms_eps)
        q = qp.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = kp.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = vp.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm == "head":
            q = rms_norm(q, lp["q_norm"][li], eps=cfg.rms_eps)
            k = rms_norm(k, lp["k_norm"][li], eps=cfg.rms_eps)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if attn_mscale != 1.0:  # YaRN temperature: logits scale by mscale^2
            q = q * torch.tensor(attn_mscale, dtype=q.dtype)
        write_kv(kf, vf, k, v, slots_all[li])
        if attn_impl == "reference":
            attn = paged_attention_reference(q, kf, vf, tables_all[li], positions)
        else:
            attn = paged_attention(q.contiguous(), kf, vf, tables_all[li], positions,
                                   contiguous_positions=contiguous_positions)
        x = x + _qmm(attn.reshape(b, t, cfg.q_dim), take_layer(lp["wo"], li))
        h2 = rms_norm(x, lp["mlp_norm"][li], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
        x = x + _mlp_dense(lp, li, h2, cfg.mlp_act)
    x = rms_norm(x, params["norm_f"], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if logit_indices is not None:
        v_cols = logit_indices.shape[1]
        sel = torch.gather(x, 1, logit_indices.long()[:, :, None].expand(b, v_cols, x.shape[-1]))
        return _head_logits(sel.reshape(b * v_cols, -1), head).reshape(b, v_cols, -1), k_cache, v_cache
    last = x[torch.arange(b, device=dev), last_token_index.long()]  # [B, D]
    return _head_logits(last, head), k_cache, v_cache
