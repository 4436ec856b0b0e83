"""Multi-head Latent Attention (DeepSeek-V2/V3) on the paged cache
(counterpart of ``dynamo_tpu/models/mla.py``).

MLA caches one shared **latent** per token, the KV-compressed vector ``c``
(``kv_lora_rank`` wide), plus a decoupled rope key, in place of per-head
K/V. The paged caches keep the GQA geometry: ``k_cache`` holds the latents,
``v_cache`` the rope keys, lane-padded to ``max(qk_rope_head_dim, 128)``
with a zero tail (the JAX build's layout, so caches compare and pages can be
exchanged with a JAX worker).

The attention is the **absorbed** formulation: queries are projected into
latent space (``q_nope @ W_uk``), attention runs directly against the cached
latents (``ops/paged_mla.py``: the CUDA kernel on the card, its plain
version on the CPU), and ``W_uv`` applies once to the latent output. The
projections go through ``quant_matmul`` (quantized leaves in the kernel of
``ops/quant_matmul.py`` on the card); the head-wise einsums (``w_uk``,
``w_uv``, never quantized) are plain products, as the JAX build leaves them
to XLA. ``impl="reference"`` runs the gather formulation.
Ring attention and the device mesh are not ported.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import quant_matmul as _qmm
from dynamo_tpu_torch.ops.attention import NEG_INF, store_rows
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.ops.paged_mla import paged_mla
from dynamo_tpu_torch.ops.rope import apply_rope

Params = dict


def init_mla_params(cfg: ModelConfig, weight, const, num_layers: int) -> dict:
    """MLA attention leaves, layers stacked on the leading axis: the JAX
    build's leaves, shapes and fan-ins, made by ``llama.build_params``'s
    ``weight(name, shape, fan_in)`` and ``const(shape, value)``."""
    d, h, nl = cfg.hidden_size, cfg.num_heads, num_layers
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    leaves = {
        # x -> compressed kv latent + decoupled rope key (shared, one "head")
        "w_kv_a": weight("w_kv_a", (nl, d, r_kv + dr), d),
        "kv_norm": const((nl, r_kv), 1.0),
        # latent -> per-head K_nope / V
        "w_uk": weight("w_uk", (nl, r_kv, h, dn), r_kv),
        "w_uv": weight("w_uv", (nl, r_kv, h, dv), r_kv),
        "wo_mla": weight("wo_mla", (nl, h * dv, d), h * dv),
    }
    if r_q > 0:
        leaves["w_q_a"] = weight("w_q_a", (nl, d, r_q), d)
        leaves["q_norm"] = const((nl, r_q), 1.0)
        leaves["w_q_b"] = weight("w_q_b", (nl, r_q, h * (dn + dr)), r_q)
    else:
        leaves["w_q"] = weight("w_q", (nl, d, h * (dn + dr)), d)
    return leaves


def mla_cache_widths(cfg: ModelConfig) -> tuple[int, int]:
    """(k_cache width, v_cache width): latents and rope keys, the rope stream
    padded to one 128-lane tile as in the JAX build. Readers take
    ``[..., :qk_rope_head_dim]``; writers zero-fill the tail."""
    return cfg.kv_lora_rank, max(cfg.qk_rope_head_dim, 128)


def _queries(lp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor):
    """(q_nope, roped q_rope), each [B, T, H, ·]: q-LoRA or the direct projection."""
    b, t, _ = h.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_q_a" in lp:
        q_a = rms_norm(_qmm(h, lp["w_q_a"]), lp["q_norm"], eps=cfg.rms_eps)
        q = _qmm(q_a, lp["w_q_b"]).reshape(b, t, cfg.num_heads, dn + dr)
    else:
        q = _qmm(h, lp["w_q"]).reshape(b, t, cfg.num_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, inv_freq)


def mla_attention(
    lp: Params,  # one layer's leaves
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, T, D] normed input
    positions: torch.Tensor,  # i32[B, T]
    c_cache: torch.Tensor,  # [P, ps, r_kv] latents; updated in place
    r_cache: torch.Tensor,  # [P, ps, r_width] rope keys; updated in place
    block_tables: torch.Tensor,  # i32[B, pages_per_seq]
    slot_mapping: torch.Tensor,  # [B, T] flat slots (0 = the null page, for padding)
    inv_freq: torch.Tensor,  # [qk_rope_head_dim // 2]
    attn_mscale: float = 1.0,  # YaRN temperature (mscale^2), folded into the scale
    impl: str | None = None,  # None: paged_mla (kernel on the card); "reference": gather formulation
    walk: tuple[torch.Tensor, torch.Tensor] | None = None,  # paged_mla's walk_facts(positions), once per step
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MLA layer: returns (attn_out [B, T, D], c_cache, r_cache), the
    caches being the same tensors, written through before attention."""
    b, t, _ = h.shape
    n_heads = cfg.num_heads
    r_kv, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    # -- latent + rope key, written through to the paged cache -------------
    kv_a = _qmm(h, lp["w_kv_a"])  # [B, T, r_kv + dr]
    c = rms_norm(kv_a[..., :r_kv], lp["kv_norm"], eps=cfg.rms_eps)
    k_rope = apply_rope(kv_a[..., None, r_kv:], positions, inv_freq)[:, :, 0]  # [B, T, dr]
    r_width = r_cache.shape[2]
    slots = slot_mapping.reshape(-1).long()
    store_rows(c_cache, slots, c.reshape(-1, r_kv))
    # The rope stream is lane-padded (mla_cache_widths): zero-fill the tail.
    store_rows(r_cache, slots, torch.nn.functional.pad(k_rope.reshape(-1, dr), (0, r_width - dr)))

    # -- queries, absorbed into latent space -------------------------------
    q_nope, q_rope = _queries(lp, cfg, h, positions, inv_freq)
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, lp["w_uk"])  # [B, T, H, r_kv]
    scale = (dn + dr) ** -0.5 * attn_mscale

    if impl == "reference":
        out_lat = _gather_attention(q_lat, q_rope, c_cache, r_cache, block_tables, positions, scale)
    elif impl is None:
        out_lat = paged_mla(q_lat.contiguous(), q_rope.contiguous(), c_cache, r_cache, block_tables, positions,
                            scale=scale, walk=walk)  # f32 [B, T, H, r_kv]
    else:
        raise ValueError(f"unknown impl {impl!r} (want None or 'reference')")
    out = torch.einsum("bthr,rhv->bthv", out_lat.to(h.dtype), lp["w_uv"])  # [B, T, H, dv]
    return _qmm(out.reshape(b, t, n_heads * dv), lp["wo_mla"]), c_cache, r_cache


def _gather_attention(q_lat, q_rope, c_cache, r_cache, block_tables, positions, scale: float) -> torch.Tensor:
    """The gather formulation (JAX ``models/mla.py:221-240``): every page of
    the batch's tables gathered, f32 scores, masked softmax; f32 latent out."""
    b = q_lat.shape[0]
    dr = q_rope.shape[-1]
    _, ps, r_kv = c_cache.shape
    s = block_tables.shape[1] * ps
    idx = block_tables.reshape(-1).long()
    c_pages = c_cache[idx].reshape(b, s, r_kv)
    r_pages = r_cache[idx].reshape(b, s, r_cache.shape[2])[..., :dr]
    logits = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c_pages.float())
              + torch.einsum("bthr,bsr->bhts", q_rope.float(), r_pages.float())) * scale
    key_pos = torch.arange(s, device=q_lat.device, dtype=torch.int32)
    mask = key_pos[None, None, :] <= positions[:, :, None]  # [B, T, S]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bsr->bthr", probs.to(c_pages.dtype).float(), c_pages.float())


def mla_attention_naive(
    lp: Params,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, T, D]
    positions: torch.Tensor,  # i32[B, T]
    inv_freq: torch.Tensor,
    attn_mscale: float = 1.0,
) -> torch.Tensor:
    """Golden reference: per-head K/V materialized, no cache, full causal
    self-attention on true positions. The absorbed paged form must match it
    on whole sequences."""
    b, t, _ = h.shape
    n_heads = cfg.num_heads
    r_kv, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    kv_a = _qmm(h, lp["w_kv_a"])
    c = rms_norm(kv_a[..., :r_kv], lp["kv_norm"], eps=cfg.rms_eps)
    k_rope = apply_rope(kv_a[..., None, r_kv:], positions, inv_freq)  # [B, T, 1, dr]
    k_nope = torch.einsum("btr,rhn->bthn", c, lp["w_uk"])  # [B, T, H, dn]
    v = torch.einsum("btr,rhv->bthv", c, lp["w_uv"])  # [B, T, H, dv]
    q_nope, q_rope = _queries(lp, cfg, h, positions, inv_freq)

    k = torch.cat([k_nope, k_rope.expand(b, t, n_heads, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    scale = (dn + dr) ** -0.5 * attn_mscale
    logits = torch.einsum("bthd,bshd->bhts", qf.float(), k.float()) * scale
    mask = positions[:, :, None] >= positions[:, None, :]  # causal on true positions
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshv->bthv", probs.to(v.dtype).float(), v.float())
    return _qmm(out.to(h.dtype).reshape(b, t, n_heads * dv), lp["wo_mla"])
