"""RMSNorm, computed in float32 whatever the input dtype and cast back on exit
(counterpart of ``dynamo_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """``plus_one``: Gemma's zero-centered convention — output
    ``normed * (1 + w)``, the one added in f32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    w32 = weight.float()
    if plus_one:
        w32 = w32 + 1.0
    return (normed * w32).to(x.dtype)
