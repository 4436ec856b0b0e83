"""Rotary position embeddings (RoPE), with Llama-3 frequency scaling.

Counterpart of ``dynamo_tpu/ops/rope.py``: the frequency table is the same
numpy computation, rotation uses the Llama "split halves" convention at
arbitrary absolute positions (paged decode needs per-token positions).
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0, scaling: dict | None = None) -> np.ndarray:
    """Inverse frequencies f32[head_dim//2], with optional rope scaling
    (HF schema: llama3, linear or yarn)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    rope_type = (scaling or {}).get("rope_type", (scaling or {}).get("type"))
    if rope_type in (None, "none", "default"):
        pass
    elif rope_type == "llama3":
        factor = float(scaling["factor"])
        lo = float(scaling["low_freq_factor"])
        hi = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * np.pi / inv_freq
        # Three bands: long wavelengths fully scaled, short untouched, smooth ramp between.
        smooth = np.clip((orig / wavelen - lo) / (hi - lo), 0.0, 1.0)
        scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(wavelen > orig / lo, inv_freq / factor, scaled)
    elif rope_type == "linear":
        inv_freq = inv_freq / float(scaling["factor"])
    elif rope_type == "yarn":
        factor = float(scaling["factor"])
        orig = float(scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))
        dims = np.arange(0, head_dim, 2, dtype=np.float64)

        def corr_dim(num_rot: float) -> float:
            return (head_dim * np.log(orig / (num_rot * 2.0 * np.pi))) / (2.0 * np.log(theta))

        low = max(np.floor(corr_dim(beta_fast)), 0.0)
        high = min(np.ceil(corr_dim(beta_slow)), head_dim - 1.0)
        ramp = np.clip((dims / 2.0 - low) / max(high - low, 1e-3), 0.0, 1.0)
        inv_freq = inv_freq / factor * ramp + inv_freq * (1.0 - ramp)
    else:
        raise ValueError(
            f"unsupported rope scaling type {rope_type!r} (supported: llama3, linear, yarn) — "
            f"serving with unscaled frequencies would silently corrupt long-context output"
        )
    return inv_freq.astype(np.float32)


def rope_attention_factor(scaling: dict | None) -> float:
    """YaRN attention-temperature scaling (mscale); 1.0 for other types."""
    if not scaling or scaling.get("rope_type", scaling.get("type")) != "yarn":
        return 1.0
    explicit = scaling.get("attention_factor")
    if explicit is not None:
        return float(explicit)
    factor = float(scaling.get("factor", 1.0))
    return 0.1 * float(np.log(factor)) + 1.0 if factor > 1.0 else 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., T, n_heads, head_dim] at absolute ``positions`` [..., T]."""
    angles = positions[..., None].float() * inv_freq  # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
