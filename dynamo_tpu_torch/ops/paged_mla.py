"""Paged MLA attention over the latent cache: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces ``dynamo_tpu/ops/pallas_mla.py:_mla_decode_kernel`` (launched at
``:291`` by ``mla_paged_decode``) and its host-side combine. Kernel source:
``csrc/paged_mla.cu``, whose header note gives the bound (the shared latent
stream's bytes at decode, operations at prefill chunks and mixed steps) and
what the Hopper design does about it (64-row tiles on wgmma, a TMA ring,
splits merged inside a thread block cluster; fp8 key tiles converted in
place in the bf16 ring, once per share group of two row tiles).

Both versions compute the same function. MLA in the absorbed form is
multi-query attention: per (sequence, query token, head) the scores are
``q_lat . c + q_rope . r[:dr]`` over the paged latent ``c [P, ps, r_kv]``
and rope-key ``r [P, ps, r_width]`` streams (only the first ``dr =
q_rope.shape[-1]`` rope lanes are read), the value is ``c`` itself, each
query masked to ``kpos <= positions[b, t]``, the output f32 in latent
space. Queries are scaled in f32 and rounded to the cache dtype first (bf16
for an fp8 cache, whose latents and rope keys the kernel reads at 1 byte an
element and converts to bf16 on chip), as the TPU wrapper does
(``pallas_mla.py:273-276``); the kernel folds that into its staging. The
key walk is cut into split-K partials whose boundaries come from static
shapes only, merged by a log-sum-exp combine. Every T runs in
the kernel: decode, gappy verify rows, prefill chunks, mixed steps. Outputs
at a row's padding columns (tokens after the one holding the row's largest
position) are unspecified; the engine never reads them. The kernel learns
where a row's walk ends from :func:`walk_facts`, computed once per step on
the device: the forward passes it to every layer's call.

The wrapper launches the kernel for CUDA tensors (or raises) and takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops.attention import CACHE_DTYPES, FP8, NEG_INF, stage_dtype
from dynamo_tpu_torch.ops.paged_decode import MAX_SPLITS, SMEM_BYTES, _sm_count, lse_combine, split_plan

BLOCK_TOKENS = 64  # keys per split block (csrc/paged_mla.cu kBlockTokens)
ROW_TILE = 64  # query rows (token x head) per bf16 kernel block (csrc/paged_mla.cu kRows)
STAGES = 2  # bf16 kernel's key ring depth (csrc/paged_mla.cu kStages)
F32_ROW_TILE = 32  # query rows per f32 kernel block (csrc/paged_mla.cu kF32Rows)
F32_KEYS = 32  # key sub-tile of the f32 kernel (csrc/paged_mla.cu kF32Keys)
MAX_SPLIT_T = 8  # longest row whose auto plan splits the key walk
LATENT_DIMS = (128, 512)
DTYPES = (torch.bfloat16, torch.float32)  # queries

# Kernel launches through paged_mla (CUDA only): bf16/f32 caches, and the
# fp8 form. A CUDA-graph replay counts the launches its
# capture recorded (``build.count_launch``).
launches = 0
launches_fp8 = 0


def _row_atoms(r_kv: int, dr: int) -> int:
    """64-lane atoms of a bf16 key row in shared memory: latent, then rope."""
    return r_kv // 64 + -(-dr // 64)


def _wg_smem_bytes(r_kv: int, dr: int, keys: int) -> int:
    """Mirror of ``WgLayout::bytes`` (the wgmma kernel, bf16 and fp8 caches
    alike: fp8 tiles land in the bf16 ring and are converted there): alignment slack,
    the Q tile, the ring of ``keys``-key stages, the p tile, the ring's and
    the Q tile's mbarriers, the row exchange, the rows' positions and the
    (m, l) partial."""
    na = _row_atoms(r_kv, dr)
    return (1024 + na * ROW_TILE * 128 + STAGES * na * keys * 128 + ROW_TILE * 128 + (2 * STAGES + 1) * 8
            + 4 * 2 * ROW_TILE + 4 * ROW_TILE + 4 * 2 * ROW_TILE)


def _tile_keys(r_kv: int, dr: int) -> int:
    """Keys per ring stage of the wgmma kernel: 64 where they fit the shared
    memory, else 32 (rows of more than nine atoms)."""
    return 64 if _wg_smem_bytes(r_kv, dr, 64) <= SMEM_BYTES else 32


def _smem_bytes(r_kv: int, dr: int, itemsize: int) -> int:
    """Mirror of the kernel source's shared memory: ``WgLayout`` (bf16,
    fp8) or ``f32_smem_bytes`` (the query tile, a key sub-tile, scores,
    stats and positions)."""
    if itemsize <= 2:
        return _wg_smem_bytes(r_kv, dr, _tile_keys(r_kv, dr))
    return (4 * ((F32_ROW_TILE + F32_KEYS) * (r_kv + dr + 4) + F32_ROW_TILE * (F32_KEYS + 1) + 3 * F32_ROW_TILE)
            + 4 * F32_ROW_TILE)


def paged_mla_supported(n_heads: int, r_kv: int, r_width: int, dr: int, page_size: int, *,
                        q_dtype: torch.dtype, cache_dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: latent width 128 or 512, a rope width ``dr``
    that is a multiple of 16 within the cache's ``r_width`` (whose rows are
    16-byte aligned), pages of a power of 2 tokens, at least 2 (a 32-key
    sub-tile of the f32 kernel spans at most 16 pages), bf16 or f32 queries,
    bf16, f32 or fp8 caches, and the shared-memory tiles within the block's
    budget. Any head count and any T."""
    if r_kv not in LATENT_DIMS or q_dtype not in DTYPES or cache_dtype not in CACHE_DTYPES or n_heads < 1:
        return False
    if page_size < 2 or page_size & (page_size - 1):
        return False
    itemsize = cache_dtype.itemsize
    if dr < 16 or dr % 16 or dr > r_width or (r_width * itemsize) % 16:
        return False
    return _smem_bytes(r_kv, dr, itemsize) <= SMEM_BYTES


def walk_facts(positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's largest position (int32 ``[B]``: its walk length less 1 and
    its last page) and the first token holding it (int64 ``[B]``: the tokens
    past it are padding), in one reduction on the positions' device. Any
    token holding the max would be a safe answer (a later one only costs
    padding work); ``torch.max`` gives the first."""
    return torch.max(positions, dim=1)


def mla_split_plan(batch: int, t_q: int, pages_per_seq: int, page_size: int, num_splits: int,
                   device: torch.device) -> tuple[int, int]:
    """(num_splits, key blocks per split) from static shapes only.

    ``num_splits > 0`` is taken as given (clamped to the block count and to
    MAX_SPLITS: a row tile's splits are one thread block cluster). Auto
    (``<= 0``): rows of up to ``MAX_SPLIT_T`` tokens (decode, verify) split
    the walk toward one block per SM over the batch (at 32 heads a token's
    rows fit one row tile), at most MAX_SPLITS; longer rows walk unsplit,
    their row tiles fill the card already. On the CPU auto is 1. A T_q = 1
    decode and a verify row of a few tokens share one plan, which their
    bitwise equality needs."""
    if num_splits <= 0:
        if t_q > MAX_SPLIT_T:
            num_splits = 1
        elif device.type == "cuda":
            sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
            num_splits = max(1, sms // max(1, batch))
    return split_plan(batch, 1, pages_per_seq, page_size, min(num_splits, MAX_SPLITS), device)


def mla_share_plan(t_q: int, n_heads: int, splits: int, cache_dtype: torch.dtype) -> int:
    """Row tiles of one sequence that fill each key tile once between them
    (a share group, one thread block cluster; ``csrc/paged_mla.cu``): 2 for
    an fp8 cache with an unsplit walk over at least 2 row tiles, 1
    otherwise (groups of 4 and 8 measured slower than none on an H100:
    PERF.md §6, PR 8). The plan changes no row's arithmetic: every rank
    walks the same key tiles in the same order."""
    return 2 if cache_dtype == FP8 and splits == 1 and t_q * n_heads > ROW_TILE else 1


def paged_mla_plain(q_lat, q_rope, c_cache, r_cache, block_tables, positions, *, scale: float,
                    num_splits: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gathered latent and rope pages,
    f32 scores of the pre-scaled queries staged in :func:`stage_dtype` (the
    cache's, bf16 for fp8), per-split softmax partials with p masked
    explicitly and rounded to the same dtype for the value product, then
    :func:`lse_combine`."""
    b, t, h, r_kv = q_lat.shape
    dr = q_rope.shape[-1]
    _, ps, r_width = r_cache.shape
    splits, bps = mla_split_plan(b, t, block_tables.shape[1], ps, num_splits, q_lat.device)
    idx = block_tables.clamp(min=0).reshape(-1).long()
    s_len = block_tables.shape[1] * ps
    c = c_cache[idx].reshape(b, s_len, r_kv).float()
    r = r_cache[idx].reshape(b, s_len, r_width)[..., :dr].float()
    st = stage_dtype(c_cache.dtype)
    ql = (q_lat.float() * scale).to(st).float()
    qr = (q_rope.float() * scale).to(st).float()
    logits = torch.einsum("bthr,bsr->bths", ql, c) + torch.einsum("bthr,bsr->bths", qr, r)  # [B, T, H, S]
    key_pos = torch.arange(s_len, device=q_lat.device, dtype=torch.int32)
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, :, None]  # [B, T, 1, S]
    logits = torch.where(mask, logits, NEG_INF)
    span = bps * BLOCK_TOKENS
    accs, ms, ls = [], [], []
    for sp in range(splits):
        lo, hi = sp * span, min((sp + 1) * span, s_len)
        if lo >= hi:  # an empty split
            ms.append(torch.full((b, t, h), NEG_INF, device=q_lat.device))
            ls.append(torch.zeros((b, t, h), device=q_lat.device))
            accs.append(torch.zeros((b, t, h, r_kv), device=q_lat.device))
            continue
        sl = logits[..., lo:hi]
        m = sl.amax(dim=-1)
        p = torch.where(mask[..., lo:hi], torch.exp(sl - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bths,bsr->bthr", p.to(st).float(), c[:, lo:hi]))
    return lse_combine(torch.stack(accs, 1), torch.stack(ms, 1), torch.stack(ls, 1))


def check_mla_args(q_lat, q_rope, c_cache, r_cache, block_tables, positions) -> None:
    """Raise ValueError unless the arguments have the layout the kernel reads:
    one device, contiguous, ``q_lat [B, T, H, r_kv]`` and ``q_rope [B, T, H,
    dr]`` of one dtype, caches ``[P, ps, r_kv]`` and ``[P, ps, r_width]`` of
    one dtype (these four 16-byte aligned: the kernel reads them in 16-byte
    vectors), int32 ``block_tables [B, N]`` and ``positions [B, T]``."""
    named = (("q_lat", q_lat), ("q_rope", q_rope), ("c_cache", c_cache), ("r_cache", r_cache),
             ("block_tables", block_tables), ("positions", positions))
    for name, x in named:
        if x.device != q_lat.device:
            raise ValueError(f"{name} is on {x.device}, q_lat on {q_lat.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype in CACHE_DTYPES and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if (q_lat.dim() != 4 or q_rope.dim() != 4 or q_rope.shape[:3] != q_lat.shape[:3] or q_rope.dtype != q_lat.dtype
            or c_cache.dim() != 3 or r_cache.dim() != 3 or c_cache.shape[:2] != r_cache.shape[:2]
            or c_cache.shape[2] != q_lat.shape[3] or c_cache.dtype != r_cache.dtype):
        raise ValueError(f"bad shapes: q_lat {tuple(q_lat.shape)} {q_lat.dtype}, q_rope {tuple(q_rope.shape)} "
                         f"{q_rope.dtype}, c {tuple(c_cache.shape)} {c_cache.dtype}, r {tuple(r_cache.shape)} "
                         f"{r_cache.dtype}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    b, t = q_lat.shape[:2]
    if block_tables.dim() != 2 or block_tables.shape[0] != b or tuple(positions.shape) != (b, t):
        raise ValueError(f"bad table/position shapes {tuple(block_tables.shape)} / {tuple(positions.shape)}")


def paged_mla(q_lat, q_rope, c_cache, r_cache, block_tables, positions, *, scale: float,
              num_splits: int = 0, walk: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Paged MLA attention; returns f32 ``[B, T, H, r_kv]`` in latent space.

    ``q_lat [B, T, H, r_kv]``, ``q_rope [B, T, H, dr]`` (unpadded), caches
    ``[P, ps, r_kv]`` / ``[P, ps, r_width]``, ``block_tables i32[B, N]``
    (-1 tails allowed), ``positions i32[B, T]`` (any layout: causality is
    per query token). ``num_splits`` 0 = auto (:func:`mla_split_plan`).
    ``walk``: ``walk_facts(positions)``, for a caller that runs several
    layers on one step's positions; computed here when not given."""
    if q_lat.device.type == "cpu":
        return paged_mla_plain(q_lat, q_rope, c_cache, r_cache, block_tables, positions,
                               scale=scale, num_splits=num_splits)
    check_mla_args(q_lat, q_rope, c_cache, r_cache, block_tables, positions)
    b, t, h, r_kv = q_lat.shape
    dr = q_rope.shape[-1]
    _, ps, r_width = r_cache.shape
    if not paged_mla_supported(h, r_kv, r_width, dr, ps, q_dtype=q_lat.dtype, cache_dtype=c_cache.dtype):
        raise NotImplementedError(f"paged_mla kernel does not take heads={h}, r_kv={r_kv}, rope {dr} of "
                                  f"{r_width}, page size {ps}, q {q_lat.dtype}, cache {c_cache.dtype}")
    splits, bps = mla_split_plan(b, t, block_tables.shape[1], ps, num_splits, q_lat.device)
    # A single-token row's walk facts are its one position: the kernel reads it.
    if t == 1:
        walk = (None, None)
    elif walk is None:
        walk = walk_facts(positions)
    out = torch.empty((b, t, h, r_kv), dtype=torch.float32, device=q_lat.device)
    fn = build.load("paged_mla")
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(), r_cache.data_ptr(), block_tables.data_ptr(),
             positions.data_ptr(), *(x.data_ptr() if x is not None else None for x in walk), out.data_ptr(),
             b, t, h, r_kv, dr, r_width, ps, block_tables.shape[1], c_cache.shape[0], splits, bps,
             mla_share_plan(t, h, splits, c_cache.dtype), build.DTYPE_CODES[c_cache.dtype],
             build.DTYPE_CODES[q_lat.dtype], float(scale), build.stream_of(q_lat))
    build.check_launch("paged_mla", err)
    build.count_launch(globals(), "launches_fp8" if c_cache.dtype == FP8 else "launches")
    return out
