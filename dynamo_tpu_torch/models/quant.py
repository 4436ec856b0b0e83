"""Weight-only quantization for serving: int8 (per-channel) and packed int4
(group-wise) (counterpart of ``dynamo_tpu/models/quant.py``).

Matmul weights are stored narrow and multiplied by a hand-written kernel that
dequantizes them on chip (``ops/quant_matmul.py``, ``csrc/quant_matmul.cu``),
where the JAX build leaves XLA to fuse the dequantization into the dot's
operand read: either way the full-width weight never reaches device memory,
so decode streams 1 byte (int8) or 0.5 byte (int4) a weight.

Two leaf formats, distinguished by key, bit for bit the JAX build's:

- int8: ``{"qw": int8[..., d_in, d_out], "scale": bf16[..., d_out]}``,
  per-output-channel symmetric; the scale applies to the product's output.
- int4: ``{"qw4": int8[..., d_in//2, d_out], "scale": bf16[..., G, d_out]}``
  plus an optional ``"qbias"`` (GGUF ``Q4_K`` imports, whose scale and bias
  stay float32). Element ``2i`` in the low nibble of byte ``i``, ``2i+1`` in
  the high one; ``G = d_in // group_size`` groups along the contraction axis.

Quantization runs in float32 and rounds as the JAX build does (the scale
rounded to bf16 before the divide, round half to even, the same clips), so a
checkpoint quantized here equals its JAX quantization. Every quantized
projection goes through :func:`quant_matmul` (``models/llama.py``,
``models/mla.py``): the kernel for CUDA tensors, the plain version for CPU
ones. Embeddings, norms and biases stay bf16; so do MLA's absorbed
``w_uk``/``w_uv``. A routed-MoE model is refused by name (``MOE_REFUSAL``):
its 4-D expert leaves have no quantized form in the grouped kernel yet
(ROADMAP B6), and quantizing them would make leaves no kernel takes.
``--quantize int8|int4``; the int4 group width is ``DYN_QUANT_GROUP_SIZE``
(default 128; GGUF Q4 imports keep their native 32).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.ops import quant_matmul as qmm
from dynamo_tpu_torch.ops.quant_matmul import dequant_int4 as _dequant_int4
from dynamo_tpu_torch.ops.quant_matmul import is_quantized, unpack_int4

__all__ = [
    "QUANT_MODES", "default_group_size", "init_params_quantized", "is_quantized", "maybe_dequant", "pack_int4",
    "quant_matmul", "quantize_leaf", "quantize_leaf_int4", "quantize_params", "take_layer", "unpack_int4",
    "_dequant_int4",
]

# Leaves that are matmul weights, by name, at any nesting depth.
_MATMUL_LEAVES = frozenset(
    {
        "wq", "wk", "wv", "wo",
        "w_gate", "w_up", "w_down",
        "w_shared_gate", "w_shared_up", "w_shared_down",
        "lm_head",
        # MLA 2D projections (models/mla.py). The absorbed per-head tensors
        # (w_uk/w_uv, 3-axis einsums) stay bf16: their contraction axis is
        # not the stored-scale axis.
        "w_q_a", "w_q_b", "w_q", "w_kv_a", "wo_mla",
    }
)

#: Modes accepted by quantize_params / init_params_quantized.
QUANT_MODES = ("int8", "int4")


def default_group_size() -> int:
    """int4 group width along the contraction axis (DYN_QUANT_GROUP_SIZE)."""
    return int(os.environ.get("DYN_QUANT_GROUP_SIZE", "128"))


def _pick_group_size(d_in: int, group_size: int) -> int:
    """Largest even divisor of ``d_in`` that is <= the requested width
    (group boundaries align with nibble pairs, and every group is full)."""
    gs = min(group_size, d_in)
    while gs > 2 and (d_in % gs or gs % 2):
        gs -= 2 if gs % 2 == 0 else 1
    return max(gs, 2)


MOE_REFUSAL = ("weight-only quantization of a MoE model: quantized expert leaves (4-D int8/int4 experts, "
               "maybe_dequant in parallel/moe.py, the grouped kernel's quantized forms, GGUF expert tensors) are "
               "not ported to dynamo_tpu_torch yet (ROADMAP B6)")


def _check_mode(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r} (supported: {', '.join(QUANT_MODES)})")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``[..., d_in, O]`` int4-valued int8 -> ``[..., d_in//2, O]`` packed
    bytes: element ``2i`` in the low nibble of byte ``i``, ``2i+1`` in the
    high nibble. Values must be in [-8, 7]."""
    lo = q[..., 0::2, :].to(torch.uint8)
    hi = q[..., 1::2, :].to(torch.uint8)
    return ((hi << 4) | (lo & 0x0F)).view(torch.int8)


def _per_layer(fn, w: torch.Tensor, **kw) -> dict[str, torch.Tensor]:
    """``fn`` over a leaf's leading (layer) axis one slice at a time, the
    results stacked: the same arrays as one call over the whole leaf (every
    reduction runs within a slice), with one slice's float32 transients."""
    if w.dim() <= 2:
        return fn(w, **kw)
    parts = [_per_layer(fn, w[i], **kw) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def _quantize_int8(w: torch.Tensor, *, scale_dtype: torch.dtype) -> dict[str, torch.Tensor]:
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2)  # [d_out]
    # The scale is rounded to its stored width before the divide, so the
    # quants are optimal for the scale the dequant uses.
    scale = torch.where(amax > 0, amax / torch.tensor(127.0, device=w.device), 1.0).to(scale_dtype)
    q = torch.clamp(torch.round(w32 / scale.to(torch.float32)[None, :]), -127, 127).to(torch.int8)
    return {"qw": q, "scale": scale}


def _quantize_int4(w: torch.Tensor, *, gs: int, scale_dtype: torch.dtype) -> dict[str, torch.Tensor]:
    d_in, d_out = w.shape
    w32 = w.to(torch.float32).reshape(d_in // gs, gs, d_out)
    amax = w32.abs().amax(dim=-2)  # [G, d_out]
    scale = torch.where(amax > 0, amax / torch.tensor(7.0, device=w.device), 1.0).to(scale_dtype)
    q = torch.clamp(torch.round(w32 / scale.to(torch.float32)[:, None, :]), -7, 7).to(torch.int8)
    return {"qw4": pack_int4(q.reshape(d_in, d_out)), "scale": scale}


def quantize_leaf(w: torch.Tensor, *, scale_dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: ``w[..., d_in, d_out]``."""
    return _per_layer(_quantize_int8, w, scale_dtype=scale_dtype)


def quantize_leaf_int4(w: torch.Tensor, *, group_size: int | None = None,
                       scale_dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Symmetric group-wise packed int4: ``w[..., d_in, d_out]``; quants clip
    to [-7, 7] (the -8 code is left to asymmetric imports)."""
    d_in = w.shape[-2]
    if d_in % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {d_in}")
    gs = _pick_group_size(d_in, group_size or default_group_size())
    return _per_layer(_quantize_int4, w, gs=gs, scale_dtype=scale_dtype)


def quantize_params(params: dict, *, mode: str = "int8", inplace: bool = False) -> dict:
    """A params tree with its matmul weights replaced by quantized leaves
    (int8 per-channel or packed int4 group-wise), each on its leaf's
    device, one layer at a time. With ``inplace`` the input's dicts take
    each quantized leaf as soon as it is made, so a full-width leaf the
    caller holds no other reference to is freed before the next one is
    quantized (the launcher's path, to bound the peak)."""
    if mode in ("", "none", None):
        return params
    _check_mode(mode)
    q_leaf = quantize_leaf if mode == "int8" else quantize_leaf_int4

    def walk(tree: Any, name: str | None) -> Any:
        if isinstance(tree, dict) and not is_quantized(tree):
            out = tree if inplace else {}
            for k in list(tree):
                out[k] = walk(tree[k], k)
            return out
        if name in _MATMUL_LEAVES and not is_quantized(tree):
            if tree.dim() == 4:  # a [L, E, K, N] expert stack
                raise NotImplementedError(f"--quantize {mode}: {MOE_REFUSAL}")
            return q_leaf(tree)
        return tree

    return walk(params, None)


def take_layer(leaf: Any, li: int) -> Any:
    """Layer ``li`` of a layer-stacked leaf: a plain tensor or a quantized
    leaf dict, sliced inside."""
    if isinstance(leaf, dict):
        return {k: v[li] for k, v in leaf.items()}
    return leaf[li]


def quant_matmul(x: torch.Tensor, leaf: Any, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` for a possibly-quantized weight, in ``out_dtype`` (None:
    x's dtype). A quantized leaf goes to ``ops/quant_matmul.py`` (the kernel
    for a CUDA tensor, the plain version for a CPU one); a plain weight is a
    plain matmul."""
    if is_quantized(leaf):
        return qmm.quant_matmul(x, leaf, out_dtype)
    return qmm.matmul(x, leaf, out_dtype)


def maybe_dequant(leaf: Any, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The full-width weight of a quantized leaf in ``dtype`` (plain tensors
    pass through). It materializes the weight: the serving path never calls
    it (quantized experts would, ROADMAP B6)."""
    if is_quantized(leaf):
        if "qw4" in leaf:
            return _dequant_int4(leaf, dtype)
        return leaf["qw"].to(dtype) * leaf["scale"].to(dtype)[..., None, :]
    return leaf


def init_params_quantized(cfg, seed: int = 0, *, mode: str = "int8", device: str | torch.device = "cuda") -> dict:
    """Random-init parameters directly in quantized form on ``device`` (the
    card unless the caller asks for the CPU), never making the full-width
    tree: matmul leaves are drawn in their quantized layout from a seeded
    ``torch.Generator`` (int8 uniform over [-127, 127], or packed int4 bytes
    uniform over all 256 codes, each nibble uniform over [-8, 7]) with the
    JAX build's constant fan-in scale; everything else as
    ``llama.init_params`` makes it (norms 1, biases 0, the embedding
    normal * fan_in**-0.5). The values differ from the JAX build's (another
    RNG); shapes, dtypes and scales are its."""
    from dynamo_tpu_torch.models import llama

    if mode in ("", "none", None):
        return llama.init_params(cfg, seed, device=device)
    _check_mode(mode)
    if cfg.is_moe:
        raise NotImplementedError(f"--quantize {mode}: {MOE_REFUSAL}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = llama.param_dtype(cfg)

    def quant(shape: tuple[int, ...]) -> dict:
        d_in = shape[-2]
        if mode == "int8":
            return {"qw": torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev),
                    "scale": torch.full((*shape[:-2], shape[-1]), d_in**-0.5 / 127.0, dtype=torch.bfloat16,
                                        device=dev)}
        if d_in % 2:
            raise ValueError(f"int4 packing needs an even contraction dim, got {d_in}")
        gs = _pick_group_size(d_in, default_group_size())
        return {"qw4": torch.randint(-128, 128, (*shape[:-2], d_in // 2, shape[-1]), generator=gen,
                                     dtype=torch.int8, device=dev),
                "scale": torch.full((*shape[:-2], d_in // gs, shape[-1]), d_in**-0.5 / 7.0, dtype=torch.bfloat16,
                                    device=dev)}

    def weight(name: str, shape: tuple[int, ...], fan_in: int):
        if name in _MATMUL_LEAVES:
            return quant(shape)
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * fan_in**-0.5).to(dt)

    return llama.build_params(cfg, weight, lambda shape, value: torch.full(shape, value, dtype=dt, device=dev))
