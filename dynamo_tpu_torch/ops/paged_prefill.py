"""Paged causal flash attention for contiguous query chunks: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``dynamo_tpu/ops/pallas_prefill.py:_prefill_kernel`` (launched at
``:295`` by ``paged_prefill_attention``). Kernel source:
``csrc/paged_prefill.cu``, whose header note gives the bound (bytes at short
chunks, flops at long ones) and what the design does about it.

Each row's queries are contiguous (``positions[b, t] = start_b + t`` for its
real tokens, zeros after): every prefill chunk, chunk continuations after a
prefix-cache hit, and the 1-token decode rows a mixed step carries
(start = kv_len - 1). A query attends to keys ``kpos <= qpos`` and
``kpos < kv_len`` with ``kv_len = max(positions[b]) + 1``; a query with no
attendable key gets 0, not NaN. Outputs at a row's padding columns are
unspecified (the engine never reads them).
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops.attention import CACHE_DTYPES, FP8, NEG_INF, gather_pages, stage_dtype

BLOCK_ROWS = 64  # query rows (token x head) per f32 kernel block (csrc/paged_prefill.cu kRows)
BLOCK_ROWS_BF16 = 128  # per bf16 (wgmma) kernel block (csrc/paged_prefill.cu kBlockRows)
TILE_KEYS = 128  # keys per bf16 kernel ring stage (csrc/paged_prefill.cu kTileKeys)
SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may use on Hopper
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float32)  # queries

# Kernel launches through paged_prefill_attention (CUDA only): bf16/f32
# caches, and the fp8 form. A CUDA-graph replay counts the launches its
# capture recorded (``build.count_launch``).
launches = 0
launches_fp8 = 0


def _stages(head_dim: int) -> int:
    """The tensor-core kernel's bf16 K/V ring depth (``WgSmem::kStages``)."""
    return 4 if head_dim == 64 else 2


def _fp8_stages(head_dim: int) -> int:
    """The fp8 form's fp8 ring depth (``WgSmem::kF8Stages``)."""
    return 4 if head_dim == 64 else 2


def _smem_bytes(head_dim: int, table_width: int, fp8: bool = False) -> int:
    """Mirror of ``WgSmem::bytes`` (the tensor-core kernel) in the kernel
    source: alignment slack, the 128-row query tile, the ring of K/V tiles
    of TILE_KEYS keys (128 bytes per key and 64 columns, each), for an fp8
    cache the fp8 ring of K/V tiles (head_dim bytes a key), the mbarriers
    and position scan, and (bf16) one staged page id per table entry (the
    fp8 form reads them from the table)."""
    atoms, stages = head_dim // 64, _stages(head_dim)
    f8 = _fp8_stages(head_dim) if fp8 else 0
    return (1024 + atoms * BLOCK_ROWS_BF16 * 128 + stages * 2 * atoms * TILE_KEYS * 128
            + f8 * 2 * TILE_KEYS * head_dim + 8 * (2 * stages + f8) + 16 + (0 if fp8 else 4 * table_width))


def prefill_kernel_supported(n_heads: int, head_dim: int, width: int, *, q_dtype: torch.dtype,
                             cache_dtype: torch.dtype, table_width: int = 0) -> bool:
    """Shapes the kernel takes: head_dim 64 or 128, whole GQA groups of at
    most BLOCK_ROWS heads, bf16 or f32 queries, bf16, f32 or fp8 caches,
    and (bf16) a block table of ``table_width`` pages whose ids fit in
    shared memory. The chunk width is unbounded (the grid tiles it)."""
    if head_dim not in HEAD_DIMS or width % head_dim or q_dtype not in DTYPES or cache_dtype not in CACHE_DTYPES:
        return False
    n_kv = width // head_dim
    if cache_dtype.itemsize <= 2 and _smem_bytes(head_dim, table_width, cache_dtype == FP8) > SMEM_BYTES:
        return False
    return n_heads % n_kv == 0 and n_heads // n_kv <= BLOCK_ROWS


def paged_prefill_plain(q, k_cache, v_cache, block_tables, positions, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version: gathered K/V, f32 scores of the pre-scaled
    queries staged in :func:`stage_dtype` (the cache's, bf16 for fp8), mask
    ``kpos <= qpos & kpos < kv_len``, softmax with p masked explicitly
    (rounded to the same dtype for p.V) and 0 for rows with no attendable
    key."""
    b, t, h, hd = q.shape
    _, ps, w = k_cache.shape
    n_kv = w // hd
    g = h // n_kv
    tables = block_tables.clamp(min=0)
    k = gather_pages(k_cache, tables, n_kv).float()
    v = gather_pages(v_cache, tables, n_kv).float()
    s_len = k.shape[1]
    st = stage_dtype(k_cache.dtype)
    qs = (q.float() * scale).to(st).float().reshape(b, t, n_kv, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qs, k)
    kv_len = positions.amax(dim=1) + 1  # [B]
    key_pos = torch.arange(s_len, device=q.device, dtype=torch.int32)
    mask = (key_pos[None, None, :] <= positions[:, :, None]) & (key_pos[None, None, :] < kv_len[:, None, None])
    mask = mask[:, None, None]  # [B,1,1,T,S]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1)
    # p rounded to the staging dtype before p.V, as the TPU kernel rounds it
    # (pallas_prefill.py:210); l sums the unrounded p.
    acc = torch.einsum("bkgts,bskd->bkgtd", p.to(st).float(), v)
    out = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def paged_prefill_attention(q, k_cache, v_cache, block_tables, positions, *, scale: float) -> torch.Tensor:
    """Prefill-phase (T > 1) paged flash attention; returns [B, T, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_cache, v_cache, block_tables, positions, scale=scale)
    build.check_paged_args(q, k_cache, v_cache, block_tables, positions)
    b, t, h, hd = q.shape
    _, ps, w = k_cache.shape
    if not prefill_kernel_supported(h, hd, w, q_dtype=q.dtype, cache_dtype=k_cache.dtype,
                                    table_width=block_tables.shape[1]):
        raise NotImplementedError(f"paged_prefill kernel does not take heads={h}, head_dim={hd}, width={w}, "
                                  f"q {q.dtype}, cache {k_cache.dtype}, {block_tables.shape[1]}-page tables")
    out = torch.empty_like(q)
    fn = build.load("paged_prefill")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr(), b, t, h, w // hd, hd, ps, block_tables.shape[1],
             k_cache.shape[0], build.DTYPE_CODES[k_cache.dtype], build.DTYPE_CODES[q.dtype], float(scale),
             build.stream_of(q))
    build.check_launch("paged_prefill", err)
    build.count_launch(globals(), "launches_fp8" if k_cache.dtype == FP8 else "launches")
    return out
