"""Parameter bridge from the JAX build: its parameter pytree, given as numpy
arrays, to the port's parameter dict.

The layer-stacked leaves and the ``x @ W`` (``[in, out]``) orientation are
kept as they are, so no transpose is needed. bf16 leaves cross through a
``uint16`` view and fp8 e4m3 arrays (a JAX fp8 KV cache's bytes) through a
``uint8`` view, because ``torch.from_numpy`` rejects the ml_dtypes types.
Quantized leaves (``{"qw"|"qw4", "scale"[, "qbias"]}`` dicts,
``models/quant.py``) cross bit for bit, each array as it is: a GGUF
import's float32 scale and qbias stay float32, as the JAX build holds them
(its forward rounds them to the activation dtype, and so does the port's).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device


def tensor_from_numpy(arr) -> torch.Tensor:
    """One leaf: numpy (or anything ``np.asarray`` takes) -> CPU tensor, bf16
    and fp8 e4m3 bit-exact."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict, *, device: str | torch.device = "cuda") -> dict:
    """Convert a ``dynamo_tpu.models.llama`` params pytree (numpy leaves) into
    the port's params on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor_from_numpy(node).to(device)

    return convert(tree)
