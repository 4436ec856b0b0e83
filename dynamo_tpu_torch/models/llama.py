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

Routed-MoE models (``cfg.num_experts > 0``) carry the router and the stacked
expert leaves (``w_gate/w_up [L, E, D, F]``, ``w_down [L, E, F, D]``, an
optional f32 ``router_bias`` and shared expert); their MLP is
``parallel/moe.py``'s dropless dispatch, whose expert products run in the
grouped kernel (``ops/grouped_matmul.py``) on the card. DeepSeek's
``first_k_dense`` leading dense layers sit in a ``dense_layers`` subtree that
the forward runs first, the layer counter (the cache offsets) carried
straight through, as the JAX build's two scans do.

Ring attention, multimodal inputs and sliding window raise
``NotImplementedError`` in this port.
"""

from __future__ import annotations

import os

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
from dynamo_tpu_torch.parallel.moe import moe_mlp_dropless, route_tokens

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architecture features the port does not take yet."""
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(f"attention type {cfg.attn_type!r} is not ported")
    if cfg.sliding_window > 0:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if cfg.image_token_id is not None or cfg.video_token_id is not None or cfg.mrope_section:
        raise NotImplementedError("multimodal inputs are not ported yet")


def build_params(cfg: ModelConfig, weight, const, const_f32=None) -> Params:
    """The parameter tree of ``cfg`` in the JAX build's layout and shapes:
    ``weight(name, shape, fan_in)`` makes each weight leaf (its values, or a
    quantized leaf, ``models/quant.py``), ``const(shape, value)`` each norm
    (1) and bias (0), ``const_f32`` (default ``const``) the f32 router bias;
    leaves are made in a fixed order. A model with ``first_k_dense`` leading
    dense layers gets them as a ``dense_layers`` subtree, the rest (MoE) as
    ``layers`` (``dynamo_tpu/models/llama.py:122-129``)."""
    check_supported(cfg)
    d, q, kv, f = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size

    def layer_stack(nl: int, moe: bool) -> dict:
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
        if moe:
            e, mf = cfg.num_experts, cfg.moe_intermediate_size
            layers.update({
                "router": weight("router", (nl, d, e), d),
                "w_gate": weight("w_gate", (nl, e, d, mf), d),
                "w_up": weight("w_up", (nl, e, d, mf), d),
                "w_down": weight("w_down", (nl, e, mf, d), mf),
            })
            if cfg.moe_router_bias:
                layers["router_bias"] = (const_f32 or const)((nl, e), 0.0)
            if cfg.shared_expert_size:
                fs = cfg.shared_expert_size
                layers.update({
                    "w_shared_gate": weight("w_shared_gate", (nl, d, fs), d),
                    "w_shared_up": weight("w_shared_up", (nl, d, fs), d),
                    "w_shared_down": weight("w_shared_down", (nl, fs, d), fs),
                })
                if cfg.shared_expert_gated:
                    layers["shared_gate"] = weight("shared_gate", (nl, d, 1), d)
        else:
            layers.update({
                "w_gate": weight("w_gate", (nl, d, f), d),
                "w_up": weight("w_up", (nl, d, f), d),
                "w_down": weight("w_down", (nl, f, d), f),
            })
        if cfg.attention_bias:
            layers.update({"bq": const((nl, q), 0.0), "bk": const((nl, kv), 0.0), "bv": const((nl, kv), 0.0)})
        return layers

    k_dense = cfg.first_k_dense if cfg.is_moe else 0
    layers = layer_stack(cfg.num_layers - k_dense, cfg.is_moe)
    dense_layers = layer_stack(k_dense, False) if k_dense else None
    params: Params = {
        "embed": weight("embed", (cfg.vocab_size, d), d),
        "norm_f": const((d,), 1.0),
        "layers": layers,
    }
    if dense_layers is not None:
        params["dense_layers"] = dense_layers
    if not cfg.tie_embeddings:
        params["lm_head"] = weight("lm_head", (d, cfg.vocab_size), d)
    return params


# f32 elements a random draw makes at most (1 GiB): a larger leaf is drawn a
# slab at a time straight into its (bf16) storage, so no f32 copy of a whole
# expert stack exists (qwen3-30b-a3b's w_gate is 38.6 GB in f32).
DRAW_CHUNK = 1 << 28


def _draw_normal(out: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``out`` with ``normal * scale`` rounded to its dtype: in one draw
    up to DRAW_CHUNK elements, else in slabs along the leading axis."""
    if out.numel() <= DRAW_CHUNK or out.dim() == 1:
        out.copy_(torch.randn(out.shape, generator=gen, device=out.device, dtype=torch.float32) * scale)
        return
    per = out[0].numel()
    if per > DRAW_CHUNK:
        for i in range(out.shape[0]):
            _draw_normal(out[i], gen, scale)
        return
    step = DRAW_CHUNK // per
    for i in range(0, out.shape[0], step):
        _draw_normal(out[i:i + step], gen, scale)


def init_params(cfg: ModelConfig, seed: int = 0, *, device: str | torch.device = "cuda") -> Params:
    """Random-init parameters from a seeded ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU): the JAX build's shapes and
    scales (normal * fan_in**-0.5, norms at 1, biases at 0, the router bias
    f32 0). The values differ from the JAX build's (different RNG). A leaf
    over DRAW_CHUNK elements is drawn a slab at a time into its storage."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def weight(name, shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        _draw_normal(out, gen, fan_in**-0.5)
        return out

    return build_params(cfg, weight, lambda shape, value: torch.full(shape, value, dtype=dt, device=dev),
                        lambda shape, value: torch.full(shape, value, dtype=torch.float32, device=dev))


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


def _routing_kwargs(cfg: ModelConfig) -> dict:
    """Family router semantics for ``parallel/moe.route_tokens``."""
    return dict(
        scoring=cfg.moe_scoring,
        norm_topk=cfg.moe_norm_topk,
        scaling=cfg.moe_routed_scaling,
        n_group=cfg.moe_n_group,
        topk_group=cfg.moe_topk_group,
        # noaux_tc (V3) ranks groups by top-2 sum of biased scores;
        # group_limited_greedy (V2) by per-group max.
        group_score="top2sum" if cfg.moe_router_bias else "max",
    )


# DYNAMO_MOE_DISPATCH=dense runs the dense formulation up to this many
# token-choices (N * k), as the JAX build does.
DENSE_DISPATCH_MAX = 2048


def _mlp_moe(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed MoE MLP over one layer's leaves ``lp`` (``x [B, T, D]``;
    ``dynamo_tpu/models/llama.py:183``): the dropless dispatch
    (``parallel/moe.py``), or with ``DYNAMO_MOE_DISPATCH=dense`` and at most
    DENSE_DISPATCH_MAX token-choices the dense formulation, every token
    through every expert. Where the JAX build takes its capacity dispatch
    (``DYNAMO_MOE_DISPATCH=capacity``, or ``dense`` past that size) the port
    raises: the capacity dispatch serves an ``ep`` mesh axis and comes with
    it (ROADMAP A8). Then the shared expert, sigmoid-gated for Qwen2-MoE."""
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    dispatch = os.environ.get("DYNAMO_MOE_DISPATCH", "")
    dense = dispatch == "dense" and b * t * cfg.num_experts_per_token <= DENSE_DISPATCH_MAX
    if dispatch == "capacity" or (dispatch == "dense" and not dense):
        raise NotImplementedError(
            f"DYNAMO_MOE_DISPATCH={dispatch!r} at {b * t} tokens takes the capacity dispatch, which is not "
            "ported to dynamo_tpu_torch yet (ROADMAP A8, with expert parallelism)")
    if dense:
        out = _routed_dense(lp, xt, cfg)
    else:
        out = moe_mlp_dropless(lp, xt, num_experts_per_token=cfg.num_experts_per_token, routing=_routing_kwargs(cfg))
    if cfg.shared_expert_size:
        shared = _qmm(F.silu(_qmm(xt, lp["w_shared_gate"])) * _qmm(xt, lp["w_shared_up"]), lp["w_shared_down"])
        if cfg.shared_expert_gated:
            shared = shared * torch.sigmoid((xt @ lp["shared_gate"]).float()).to(shared.dtype)
        out = out + shared
    return out.reshape(b, t, d)


def _routed_dense(lp: Params, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Routed MoE by dense compute over flattened tokens ``[N, D]``: every
    token through every expert, mixed by routing weight. The same output as
    the dropless dispatch; O(N*E) operations, so only for decode-sized N."""
    weights, topi = route_tokens(lp, xt, k=cfg.num_experts_per_token, **_routing_kwargs(cfg))
    e = lp["router"].shape[-1]
    mix = torch.zeros((xt.shape[0], e), dtype=torch.float32, device=xt.device).scatter(1, topi, weights)  # [N, E]
    gate = F.silu(torch.einsum("nd,edf->nef", xt, lp["w_gate"]))
    up = torch.einsum("nd,edf->nef", xt, lp["w_up"])
    expert_out = torch.einsum("nef,efd->ned", gate * up, lp["w_down"])  # [N, E, D]
    return torch.einsum("ned,ne->nd", expert_out.float(), mix).to(xt.dtype)


def _mlp_moe_dense(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense-compute MoE MLP over ``x [B, T, D]``: the golden model the
    dispatched path is held against in tests."""
    b, t, d = x.shape
    return _routed_dense(lp, x.reshape(b * t, d), cfg).reshape(b, t, d)


def _layer_mlp(lp: Params, li: int, x: torch.Tensor, cfg: ModelConfig, moe: bool) -> torch.Tensor:
    if moe:
        return _mlp_moe({k: take_layer(v, li) for k, v in lp.items()}, x, cfg)
    return _mlp_dense(lp, li, x, cfg.mlp_act)


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
    # (stack, its layer index, whether its MLP is MoE) for every layer li in
    # cache order: DeepSeek's leading dense layers first, then the rest.
    order = [(params["dense_layers"], j, False) for j in range(len(params["dense_layers"]["attn_norm"]))] \
        if "dense_layers" in params else []
    order += [(params["layers"], j, cfg.is_moe) for j in range(len(params["layers"]["attn_norm"]))]
    for li, (lp, j, moe) in enumerate(order):
        h = rms_norm(x, lp["attn_norm"][j], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
        if mla:
            attn_out, _, _ = mla_attention(
                {k: take_layer(v, j) for k, v in lp.items()}, cfg, h, positions, kf, vf, tables_all[li], slots_all[li],
                inv_freq, attn_mscale=attn_mscale, impl=attn_impl, walk=walk,
            )
            x = x + attn_out
            h2 = rms_norm(x, lp["mlp_norm"][j], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
            x = x + _layer_mlp(lp, j, h2, cfg, moe)
            continue
        qp, kp, vp = (_qmm(h, take_layer(lp[name], j)) for name in ("wq", "wk", "wv"))
        if cfg.attention_bias:
            qp, kp, vp = qp + lp["bq"][j], kp + lp["bk"][j], vp + lp["bv"][j]
        if cfg.qk_norm == "flat":
            qp = rms_norm(qp, lp["q_norm"][j], eps=cfg.rms_eps)
            kp = rms_norm(kp, lp["k_norm"][j], eps=cfg.rms_eps)
        q = qp.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = kp.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = vp.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm == "head":
            q = rms_norm(q, lp["q_norm"][j], eps=cfg.rms_eps)
            k = rms_norm(k, lp["k_norm"][j], eps=cfg.rms_eps)
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
        x = x + _qmm(attn.reshape(b, t, cfg.q_dim), take_layer(lp["wo"], j))
        h2 = rms_norm(x, lp["mlp_norm"][j], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
        x = x + _layer_mlp(lp, j, h2, cfg, moe)
    x = rms_norm(x, params["norm_f"], eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if logit_indices is not None:
        v_cols = logit_indices.shape[1]
        sel = torch.gather(x, 1, logit_indices.long()[:, :, None].expand(b, v_cols, x.shape[-1]))
        return _head_logits(sel.reshape(b * v_cols, -1), head).reshape(b, v_cols, -1), k_cache, v_cache
    last = x[torch.arange(b, device=dev), last_token_index.long()]  # [B, D]
    return _head_logits(last, head), k_cache, v_cache
