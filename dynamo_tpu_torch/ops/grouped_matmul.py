"""Grouped matrix product of routed MoE, ``out[r] = x[r] @ W[g(r)]`` over
token rows sorted by expert: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces no ``pl.pallas_call``: the JAX build runs a MoE layer's expert FFNs
as three ``jax.lax.ragged_dot`` calls (``dynamo_tpu/parallel/moe.py:205
moe_mlp_dropless``, ``:232-234``), a grouped matmul that XLA lowers on the
TPU. Kernel source: ``csrc/grouped_matmul.cu``, whose header note gives the
bound (the touched experts' weight bytes at decode, operations at prefill)
and what the design does about it: a grid sized from shapes alone, each
block finding its expert and row tile in ``group_offsets`` on the device,
experts with no rows owning no tile, so their weights are never read.

Arguments, as ``parallel/moe.py`` holds them: ``x [M, K]``, ``w [E, K, N]``
(each expert's matrix ``[in, out]``, no transpose), ``group_offsets
int32[E + 1]`` with ``group_offsets[0] == 0``, non-decreasing; rows past
``group_offsets[E]`` come out as zeros, as ``ragged_dot`` leaves them. The
output has x's dtype; the kernel accumulates in f32 and rounds once. The
wrapper launches the kernel for CUDA tensors (or raises, naming the shape
it does not take) and takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import build

BLOCK_M = 64  # rows of a tile (csrc/grouped_matmul.cu kBM)
BLOCK_N = 128  # columns of a tile (kBN)
BLOCK_K = 32  # K a pipeline stage (kBK)
MAX_EXPERTS = 1024  # groups a block's scan covers (kMaxExperts)
MAX_ROW_TILES = 65535  # gridDim.y

# Kernel launches through grouped_matmul (CUDA only). A CUDA-graph replay
# counts the launches its capture recorded (``build.count_launch``).
launches = 0


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over experts, ``torch.matmul`` on each
    expert's rows (the offsets read on the host). Tests and ``chip_smoke.py``
    use it; the serving path on the card never does."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    offs = group_offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[e]
    return out


def grouped_matmul_supported(k: int, n: int, experts: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Shapes the kernel takes: bf16 x and weights, K a multiple of
    BLOCK_K, N a multiple of 8 (a ragged edge past the last column tile is
    masked), 1 to MAX_EXPERTS experts. Any M from 0 up to what the grid
    holds."""
    return dtype == torch.bfloat16 and k > 0 and k % BLOCK_K == 0 and n > 0 and n % 8 == 0 \
        and 1 <= experts <= MAX_EXPERTS


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor) -> torch.Tensor:
    """``out [M, N]``, row r of ``x`` times its group's ``w[e]``: the kernel
    for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_offsets)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] or group_offsets.shape != (w.shape[0] + 1,):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_offsets {tuple(group_offsets.shape)} do not fit together")
    m, k = x.shape
    e, _, n = w.shape
    if x.dtype != w.dtype or not grouped_matmul_supported(k, n, e, x.dtype) or \
            -(-m // BLOCK_M) + e + 1 > MAX_ROW_TILES:
        raise NotImplementedError(f"grouped_matmul kernel does not take M={m}, K={k}, N={n}, E={e}, "
                                  f"x {x.dtype}, w {w.dtype}")
    if group_offsets.dtype != torch.int32:
        raise ValueError(f"group_offsets must be int32, got {group_offsets.dtype}")
    for name, t in (("x", x), ("w", w), ("group_offsets", group_offsets)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {x.device}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    fn = build.load("grouped_matmul")
    err = fn(x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(), out.data_ptr(), m, n, k, e, build.stream_of(x))
    build.check_launch("grouped_matmul", err)
    build.count_launch(globals(), "launches")
    return out
