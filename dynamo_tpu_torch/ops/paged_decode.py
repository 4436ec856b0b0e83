"""Paged GQA decode / verify attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``dynamo_tpu/ops/pallas_paged.py:_decode_kernel`` (launched at
``:507`` by ``paged_decode_attention``) and its host-side combine
``_lse_combine`` (``:212``). Kernel source: ``csrc/paged_decode.cu``, whose
header note gives the bound (HBM bytes of K/V) and what the design does
about it.

Both versions compute the same function: per (sequence, query token, head),
causal attention over the paged history with the per-row mask
``kpos <= positions[b, t]``, walked in split-K partials whose boundaries
come from static shapes only, then merged by a log-sum-exp combine. The
wrapper launches the kernel for CUDA tensors (or raises) and takes the plain
version only for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops.attention import CACHE_DTYPES, FP8, NEG_INF, gather_pages, stage_dtype

BLOCK_TOKENS = 64  # keys per kernel iteration (csrc/paged_decode.cu kBlockTokens)
STAGES = 4  # bf16 kernel's K/V ring depth (csrc/paged_decode.cu kStages)
GROUPS_FP8 = 2  # fp8 form's groups of 4 warps a block (csrc/paged_decode.cu kGroupsF8)
MAX_SPLITS = 8  # a thread block cluster's portable size: the splits of a row tile are one cluster
ROW_TILE = 16  # bf16 kernel's query rows per block (csrc/paged_decode.cu kRowTile)
MAX_VERIFY_T = 32  # query tokens per row the f32 form takes (its rows live in shared memory)
MAX_GRID_Y = 65535  # the launch grid's y extent: KV heads x 16-row tiles for the bf16 and fp8 forms
SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may use on Hopper
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float32)  # queries

# Kernel launches through paged_decode_attention (CUDA only): bf16/f32 caches,
# and the fp8 form. A CUDA-graph replay counts the launches its
# capture recorded (``build.count_launch``).
launches = 0
launches_fp8 = 0


def _smem_bytes(t_q: int, group: int, head_dim: int, itemsize: int) -> int:
    """Mirror of the kernel source's shared-memory layouts, without the
    tensor-core kernel's page ids (:func:`_page_id_bytes`). bf16 and fp8
    (``MmaSmem``): alignment slack, the K/V ring (fp8: :func:`_fp8_stages`
    deep for each of GROUPS_FP8 warp groups, at 1 byte an element, then
    each warp's two bf16 V slices of 16 keys), one 16-row query tile, the
    ring's mbarriers (one per stage and warp) and the tile's positions,
    whatever T_q. f32 (``DecodeSmem``): every row of the block's T_q x G in
    shared memory."""
    if itemsize <= 2:
        stages, groups = (STAGES, 1) if itemsize == 2 else (_fp8_stages(head_dim), GROUPS_FP8)
        warps = 4 * groups
        v_slices = 0 if itemsize == 2 else 2 * warps * 2 * 16 * head_dim
        return (1024 + itemsize * stages * groups * 2 * BLOCK_TOKENS * head_dim + v_slices
                + 2 * ROW_TILE * (head_dim + 8) + 8 * stages * warps + 4 * ROW_TILE)
    rows = t_q * group
    vec = 16 // itemsize
    return (2 * itemsize * BLOCK_TOKENS * (2 * head_dim + vec)  # double-buffered K/V tiles
            + 4 * (2 * rows * head_dim + rows * BLOCK_TOKENS + 3 * rows) + 4 * t_q)


def _fp8_stages(head_dim: int) -> int:
    """The fp8 form's ring depth (csrc/paged_decode.cu ``MmaSmem::NS``): 4 at
    hd 64; 3 at hd 128, where the layout then takes the bytes of the earlier
    8-deep one-group layout, so the page ids of every table width that
    layout took still fit."""
    return 4 if head_dim == 64 else 3


def _page_id_bytes(blocks_per_split: int, page_size: int) -> int:
    """The bf16 kernel's staged page ids of one split (``split_pages``)."""
    return 4 * (-(-(blocks_per_split * BLOCK_TOKENS) // page_size) + 1)


def row_tiles(t_q: int, group: int) -> int:
    """16-row query tiles of one (sequence, KV head): T_q x G rows, t-major."""
    return -(-t_q * group // ROW_TILE)


def decode_kernel_supported(n_heads: int, head_dim: int, width: int, t_q: int = 1, *,
                            q_dtype: torch.dtype, cache_dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: head_dim 64 or 128, whole GQA groups, bf16
    or f32 queries, bf16, f32 or fp8 caches. The bf16 and fp8 forms take
    any T_q whose row tiles fit the grid (``n_kv * row_tiles <=
    MAX_GRID_Y``: T_q up to 32,767 at 32/8 heads): neither their registers
    nor their shared memory grow with T_q. The f32 form keeps every row in
    shared memory, so it takes T_q up to MAX_VERIFY_T within the budget."""
    if head_dim not in HEAD_DIMS or width % head_dim or q_dtype not in DTYPES or cache_dtype not in CACHE_DTYPES:
        return False
    n_kv = width // head_dim
    if n_heads % n_kv or t_q < 1:
        return False
    itemsize = cache_dtype.itemsize
    fits = n_kv * row_tiles(t_q, n_heads // n_kv) <= MAX_GRID_Y if itemsize <= 2 else t_q <= MAX_VERIFY_T
    return fits and _smem_bytes(t_q, n_heads // n_kv, head_dim, itemsize) <= SMEM_BYTES


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, n_kv: int, pages_per_seq: int, page_size: int, num_splits: int,
               device: torch.device) -> tuple[int, int]:
    """(num_splits, key blocks per split) from static shapes only.

    Auto (``num_splits <= 0``) on the card aims at two waves of blocks over
    the SMs, ``batch * n_kv * splits >= 2 * SMs``; on the CPU it is 1. Never
    a function of runtime lengths: a row's reduction order must not depend
    on what else is batched or how long the other rows are."""
    max_blocks = -(-(pages_per_seq * page_size) // BLOCK_TOKENS)
    if num_splits <= 0:
        if device.type == "cuda":
            sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
            num_splits = -(-2 * sms // max(1, batch * n_kv))
        else:
            num_splits = 1
    splits = max(1, min(num_splits, max_blocks))
    return splits, -(-max_blocks // splits)


def decode_split_plan(batch: int, n_kv: int, pages_per_seq: int, page_size: int, num_splits: int,
                      device: torch.device) -> tuple[int, int]:
    """The GQA decode kernel's :func:`split_plan`: auto on the card is one
    block of one row tile per SM, ``splits = max(1, SMs // (batch * n_kv))``:
    a block past that adds start-up and merge latency but no bandwidth. The
    fp8 form fills an SM with one block of GROUPS_FP8 warp groups instead of
    more splits (a second block of clusters ran slower: PERF.md §6).
    At most MAX_SPLITS, auto or asked for: a row tile's splits are one
    thread block cluster. Static shapes only (batch bucket, KV heads, table
    width), never T_q: a T_q=1 decode and a verify row split alike."""
    if num_splits <= 0 and device.type == "cuda":
        sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
        num_splits = max(1, sms // max(1, batch * n_kv))
    return split_plan(batch, n_kv, pages_per_seq, page_size, min(num_splits, MAX_SPLITS), device)


def lse_combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Merge split partials along dim 1: ``acc`` f32[B, S, ..., hd],
    ``m``/``l`` f32[B, S, ...]. An empty split (m=NEG_INF, l=0, acc=0) scales
    by exp(NEG_INF - M) = 0 exactly; one split gives exactly acc / l."""
    m_max = m.amax(dim=1, keepdim=True)
    alpha = torch.exp(m - m_max)
    denom = (alpha * l).sum(dim=1)
    num = (acc * alpha[..., None]).sum(dim=1)
    return num / denom[..., None]


def paged_decode_plain(q, k_cache, v_cache, block_tables, positions, *, scale: float,
                       num_splits: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gathered K/V, f32 scores of the
    pre-scaled queries staged in :func:`stage_dtype` (the cache's, bf16 for
    fp8), per-split softmax partials with p masked explicitly and rounded to
    the same dtype for p.V, then :func:`lse_combine`."""
    b, t, h, hd = q.shape
    _, ps, w = k_cache.shape
    n_kv = w // hd
    g = h // n_kv
    splits, bps = decode_split_plan(b, n_kv, block_tables.shape[1], ps, num_splits, q.device)
    tables = block_tables.clamp(min=0)
    k = gather_pages(k_cache, tables, n_kv).float()  # [B, S, kv, hd]
    v = gather_pages(v_cache, tables, n_kv).float()
    s_len = k.shape[1]
    st = stage_dtype(k_cache.dtype)
    qs = (q.float() * scale).to(st).float().reshape(b, t, n_kv, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qs, k)  # [B, kv, g, T, S]
    key_pos = torch.arange(s_len, device=q.device, dtype=torch.int32)
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None, None]  # [B,1,1,T,S]
    logits = torch.where(mask, logits, NEG_INF)
    span = bps * BLOCK_TOKENS
    accs, ms, ls = [], [], []
    for sp in range(splits):
        lo, hi = sp * span, min((sp + 1) * span, s_len)
        if lo >= hi:  # an empty split
            ms.append(torch.full((b, n_kv, g, t), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, n_kv, g, t), device=q.device))
            accs.append(torch.zeros((b, n_kv, g, t, hd), device=q.device))
            continue
        sl = logits[..., lo:hi]
        m = sl.amax(dim=-1)
        p = torch.where(mask[..., lo:hi], torch.exp(sl - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        # p rounded to the staging dtype before p.V, as the TPU kernel rounds
        # it (pallas_paged.py:388); l sums the unrounded p.
        accs.append(torch.einsum("bkgts,bskd->bkgtd", p.to(st).float(), v[:, lo:hi]))
    out = lse_combine(torch.stack(accs, 1), torch.stack(ms, 1), torch.stack(ls, 1))  # [B, kv, g, T, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def paged_decode_attention(q, k_cache, v_cache, block_tables, positions, *, scale: float,
                           num_splits: int = 0) -> torch.Tensor:
    """Decode / verify paged attention; returns [B, T_q, H, hd] in q's dtype.

    ``q [B, T_q, H, hd]``, caches ``[P, ps, n_kv*hd]``, ``block_tables
    i32[B, N]`` (-1 tails allowed), ``positions i32[B, T_q]`` (gappy rows
    allowed). ``num_splits`` 0 = auto (:func:`decode_split_plan`)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, block_tables, positions,
                                  scale=scale, num_splits=num_splits)
    build.check_paged_args(q, k_cache, v_cache, block_tables, positions)
    b, t, h, hd = q.shape
    _, ps, w = k_cache.shape
    if not decode_kernel_supported(h, hd, w, t, q_dtype=q.dtype, cache_dtype=k_cache.dtype):
        raise NotImplementedError(f"paged_decode kernel does not take heads={h}, head_dim={hd}, width={w}, "
                         f"T_q={t}, q {q.dtype}, cache {k_cache.dtype}")
    n_kv = w // hd
    splits, bps = decode_split_plan(b, n_kv, block_tables.shape[1], ps, num_splits, q.device)
    itemsize = k_cache.dtype.itemsize
    if itemsize <= 2 and _smem_bytes(t, h // n_kv, hd, itemsize) + _page_id_bytes(bps, ps) > SMEM_BYTES:
        raise NotImplementedError(f"paged_decode kernel: the page ids of {bps} key blocks of {ps}-token pages "
                                  "do not fit in shared memory")
    out = torch.empty_like(q)
    fn = build.load("paged_decode")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr(),
             b, t, h, n_kv, hd, ps, block_tables.shape[1], k_cache.shape[0], splits, bps,
             build.DTYPE_CODES[k_cache.dtype], build.DTYPE_CODES[q.dtype], float(scale),
             build.stream_of(q))
    build.check_launch("paged_decode", err)
    build.count_launch(globals(), "launches_fp8" if k_cache.dtype == FP8 else "launches")
    return out
