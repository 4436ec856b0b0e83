"""Weight-only quantized matrix product ``x @ W``: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces no ``pl.pallas_call``: the JAX build writes this product as
``jnp.matmul`` over the dequantization expression
(``dynamo_tpu/models/quant.py:182 quant_matmul``, ``:148 _dequant_int4``) and
leaves XLA to fuse the dequantization into the dot's operand read. Kernel
source: ``csrc/quant_matmul.cu``, whose header note gives the bound (weight
bytes at decode, operations at prefill) and what the design does about it.

Two leaf formats (``models/quant.py``): int8 per output channel
``{"qw": int8[K, N], "scale": bf16[N]}``, and packed int4 with group scales
along K ``{"qw4": int8[K/2, N], "scale": [G, N]}`` plus an optional
``"qbias"`` (GGUF Q4_K imports; their scale and bias stay float32). Both
versions round as the JAX expression does: int8 converts exactly, and the
product rounded to the output dtype is scaled and rounded again; an int4
element is ``bf16(bf16(q * s) + b)`` in the activation dtype. The wrapper
launches the kernel for CUDA tensors (or raises) and takes the plain version
only for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from dynamo_tpu_torch.ops import build

BLOCK_K = 64  # K a pipeline stage (csrc/quant_matmul.cu kBK)
FORM_DECODE, FORM_PREFILL = 0, 1  # the kernel's two forms (csrc/quant_matmul.cu Form)
DECODE_MAX_M = 16  # rows up to which the decode form runs; the prefill form above (PERF.md: measured)
DECODE_BLOCK_N = 256  # output columns a decode block (kDecBN)
DECODE_TILES = (1, 2)  # n8 row tiles of a decode block: M up to 8, 16
DECODE_SPLIT_STAGES = 32  # K stages a decode split walks at most, as far as MAX_SPLITS allows
MAX_SPLITS = 8  # K splits of a column tile: one thread block cluster (a portable size)
MIN_SPLIT_STAGES = 4  # K stages a split walks at least
PREFILL_BLOCK_N = 128  # weight columns a prefill block (kPreCols)
PREFILL_BLOCK_M = (128, 256)  # x rows a prefill block: 256 from M 256 on where it fills a wave, else 128
PREFILL_MIN_SPLIT_STAGES = 8  # K stages a prefill split walks at least
OUT_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches through quant_matmul (CUDA only), by leaf format. A
# CUDA-graph replay counts the launches its capture recorded
# (``build.count_launch``).
launches_int8 = 0
launches_int4 = 0


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "scale" in leaf and ("qw" in leaf or "qw4" in leaf)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``[..., P, O]`` packed bytes -> ``[..., 2P, O]`` int8 values in [-8, 7]:
    element ``2i`` from the low nibble of byte ``i``, ``2i+1`` from the high
    one, each sign-extended (``dynamo_tpu/models/quant.py:97``)."""
    b = packed.to(torch.int8)
    lo = torch.bitwise_left_shift(b, 4) >> 4
    hi = b >> 4
    return torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def dequant_int4(leaf: dict, dtype: torch.dtype) -> torch.Tensor:
    """The full-width int4 weight in ``dtype``: ``q * scale`` rounded, then
    ``+ qbias`` rounded (``dynamo_tpu/models/quant.py:148``)."""
    q = unpack_int4(leaf["qw4"])
    scale = leaf["scale"]
    groups = scale.shape[-2]
    d_in, d_out = q.shape[-2], q.shape[-1]
    qg = q.reshape(*q.shape[:-2], groups, d_in // groups, d_out).to(dtype)
    w = qg * scale.to(dtype)[..., :, None, :]
    if "qbias" in leaf:
        w = w + leaf["qbias"].to(dtype)[..., :, None, :]
    return w.reshape(*q.shape[:-2], d_in, d_out)


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    """``x @ w`` with the product in ``out_dtype`` (None: x's dtype); a wider
    output than the operands' accumulates and stays in f32 (on the card one
    bf16 GEMM with f32 output; the CPU has none, so it upcasts)."""
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype).reshape(*x.shape[:-1], w.shape[-1])
    return x.to(out_dtype) @ w.to(out_dtype)


def quant_matmul_plain(x: torch.Tensor, leaf: dict, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version, JAX's formula: int8 ``(x @ qw) * scale`` with
    the product rounded to its dtype before the scale; int4 ``x @
    dequant_int4(leaf)``."""
    if "qw4" in leaf:
        return matmul(x, dequant_int4(leaf, x.dtype), out_dtype)
    y = matmul(x, leaf["qw"].to(x.dtype), out_dtype)
    return y * leaf["scale"].to(y.dtype)


def group_size(leaf: dict) -> int:
    """K elements that share one int4 scale row (0 for int8)."""
    if "qw4" not in leaf:
        return 0
    return 2 * leaf["qw4"].shape[-2] // leaf["scale"].shape[-2]


def quant_matmul_supported(k: int, n: int, *, mode: str, group: int = 0, x_dtype: torch.dtype = torch.bfloat16,
                           scale_dtype: torch.dtype = torch.bfloat16, out_dtype: torch.dtype = torch.bfloat16) -> bool:
    """Shapes the kernel takes: bf16 activations; K a multiple of BLOCK_K;
    N a multiple of 16 (a ragged edge past the last column tile is
    masked); bf16 or f32 outputs; int8 with bf16 scales; int4 with bf16 or
    f32 scales and group sizes of 32 or a multiple of BLOCK_K dividing K.
    Any M from 1 up."""
    if x_dtype != torch.bfloat16 or out_dtype not in OUT_DTYPES or k % BLOCK_K or n % 16 or k <= 0 or n <= 0:
        return False
    if mode == "int8":
        return scale_dtype == torch.bfloat16
    if mode != "int4" or scale_dtype not in (torch.bfloat16, torch.float32):
        return False
    return group > 0 and group % 32 == 0 and (BLOCK_K % group == 0 or group % BLOCK_K == 0) and k % group == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(m: int, n: int, k: int, sms: int = 132, mode: str = "int8") -> tuple[int, int, int]:
    """``(form, param, splits)`` of a launch, from shapes, the leaf format
    and the SM count alone, so a replay and an eager launch take the same
    plan and the same bits.

    Up to DECODE_MAX_M rows the decode form: ``param`` n8 row tiles (the
    fewest of DECODE_TILES that hold M) over DECODE_BLOCK_N-column tiles,
    their K range cut into ``splits``, one cluster: the fewest, a power of
    two, that keep each split within DECODE_SPLIT_STAGES stages and the
    grid at an SM's worth of blocks, at most MAX_SPLITS and each split at
    least MIN_SPLIT_STAGES stages. Above it the prefill form: ``param`` the
    block's x rows, 256 from M 256 on where the 256-row grid still has a
    block for every SM, else 128; K cut likewise (each split at least
    PREFILL_MIN_SPLIT_STAGES stages) as far as the grid stays one wave (a
    prefill block takes a whole SM's shared memory). Both formats take the
    same plan (``mode`` is the leaf format; their tiles differ in bytes, not
    in shape)."""
    del mode
    nk = k // BLOCK_K
    if m <= DECODE_MAX_M:
        mt = next(t for t in DECODE_TILES if m <= 8 * t)
        tiles = -(-n // DECODE_BLOCK_N)
        want = max(-(-nk // DECODE_SPLIT_STAGES), -(-sms // tiles))
        splits = 1
        while splits < want and 2 * splits <= min(MAX_SPLITS, nk // MIN_SPLIT_STAGES):
            splits *= 2
        return FORM_DECODE, mt, splits
    wide = m >= PREFILL_BLOCK_M[1] and -(-m // PREFILL_BLOCK_M[1]) * -(-n // PREFILL_BLOCK_N) >= sms
    rows = PREFILL_BLOCK_M[1] if wide else PREFILL_BLOCK_M[0]
    tiles = -(-m // rows) * -(-n // PREFILL_BLOCK_N)
    splits = 1
    while 2 * tiles * splits <= sms and 2 * splits <= min(MAX_SPLITS, nk // PREFILL_MIN_SPLIT_STAGES):
        splits *= 2
    return FORM_PREFILL, rows, splits


def _check_leaf(leaf: dict, k: int) -> tuple[str, torch.Tensor, int, int]:
    """(mode, weight bytes, N, group size) of a 2-D leaf whose K matches x's."""
    if "qw4" in leaf:
        qw, mode, k_w = leaf["qw4"], "int4", 2 * leaf["qw4"].shape[0]
    else:
        qw, mode, k_w = leaf["qw"], "int8", leaf["qw"].shape[0]
    if qw.dim() != 2 or k_w != k:
        raise ValueError(f"weight {tuple(qw.shape)} ({mode}) does not contract with x's last dim {k}")
    return mode, qw, qw.shape[1], group_size(leaf)


def quant_matmul(x: torch.Tensor, leaf: dict, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ W`` for a quantized 2-D leaf, in ``out_dtype`` (None:
    x's dtype): the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, leaf, out_dtype)
    k = x.shape[-1]
    mode, qw, n, gs = _check_leaf(leaf, k)
    odt = out_dtype or x.dtype
    scale, qbias = leaf["scale"], leaf.get("qbias")
    if not quant_matmul_supported(k, n, mode=mode, group=gs, x_dtype=x.dtype, scale_dtype=scale.dtype, out_dtype=odt):
        raise NotImplementedError(f"quant_matmul kernel does not take K={k}, N={n}, {mode} (group {gs}), "
                                  f"x {x.dtype}, scale {scale.dtype}, out {odt}")
    if qbias is not None and (qbias.dtype != scale.dtype or qbias.shape != scale.shape):
        raise ValueError(f"qbias {qbias.dtype} {tuple(qbias.shape)} does not match scale "
                         f"{scale.dtype} {tuple(scale.shape)}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    for name, t in (("x", x2), ("weight", qw), ("scale", scale), ("qbias", qbias)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {x.device}")
    out = torch.empty((m, n), dtype=odt, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    form, param, splits = plan(m, n, k, _sm_count(x.device.index or 0), mode)
    fn = build.load("quant_matmul")
    err = fn(x2.data_ptr(), qw.data_ptr(), scale.data_ptr(), qbias.data_ptr() if qbias is not None else None,
             out.data_ptr(), m, n, k, 0 if mode == "int8" else 1, gs, build.DTYPE_CODES[scale.dtype],
             build.DTYPE_CODES[odt], form, param, splits, build.stream_of(x))
    build.check_launch("quant_matmul", err)
    build.count_launch(globals(), f"launches_{mode}")
    return out.reshape(*x.shape[:-1], n)
