"""Paged attention over a block-table KV cache (counterpart of
``dynamo_tpu/ops/attention.py``).

Layout (per layer): ``k_cache, v_cache: [num_pages, page_size, W]`` with
``W = n_kv * head_dim`` — page-major, KV heads flattened into the trailing
dimension. A sequence's pages are listed in its row of ``block_tables:
i32[B, pages_per_seq]``; absolute position ``p`` lives at page
``block_tables[b, p // page_size]``, offset ``p % page_size``. Page 0 is the
reserved null page: padding writes land there and it is never allocated to a
sequence.

:func:`paged_attention` dispatches as the TPU build's
``paged_attention_pallas`` does: T == 1 to the decode kernel, contiguous
T > 1 to the prefill kernel, gappy T > 1 to the decode kernel in its
multi-query form. There is no fallback on the card: a kernel's wrapper
raises ``NotImplementedError`` for a CUDA shape outside its support, and
takes its plain PyTorch version only for tensors on the CPU.
:func:`paged_attention_reference` is the gather formulation the plain
versions and the tests are held against.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30  # large-but-finite: avoids NaN from (-inf) - (-inf) in masked softmax
FP8 = torch.float8_e4m3fn  # the fp8 KV cache's storage type (launch.py --kv-cache-dtype fp8)
CACHE_DTYPES = (torch.bfloat16, torch.float32, FP8)  # the KV cache types every kernel takes
FP8_NAN_ABOVE = 464.0  # |x| past the midpoint of 448 (the largest e4m3fn) and 480 rounds to NaN


def to_fp8_like_jax(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(float8_e4m3fn)`` as JAX computes it, on ``x``'s device:
    round to nearest even, and NaN (0x7F, or 0xFF below zero) for every
    |x| > 464 and for infinities and NaNs, where ``.to()`` saturates to
    ±448 on some builds. Bitwise equal to JAX's cast on every input
    (``tests/test_torch_fp8.py``, and on the card ``chip_smoke.py``)."""
    bits = x.to(FP8).view(torch.uint8)  # its sign bit is x's, NaN and saturated values alike
    # Five elementwise launches: a serving step casts every layer's K and V.
    return torch.where(x.abs() <= FP8_NAN_ABOVE, bits, bits | 0x7F).view(FP8)


def stage_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    """The type the kernels stage pre-scaled queries in and round p to before
    p.V: the cache's own, or bf16 for an fp8 cache (the TPU kernels upcast
    fp8 K/V to bf16 and keep the queries in bf16: pallas_paged.py:485-487)."""
    return cache_dtype if cache_dtype.itemsize >= 2 else torch.bfloat16


def store_rows(cache: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache.view(-1, W)[slots] = rows`` in place (``index_copy_``), cast to
    the cache's type as JAX casts (fp8: :func:`to_fp8_like_jax`, copied as
    bytes, which ``index_copy_`` takes on every device)."""
    w = cache.shape[-1]
    if cache.dtype == FP8:
        cache.view(torch.uint8).view(-1, w).index_copy_(0, slots, to_fp8_like_jax(rows).view(torch.uint8))
    else:
        cache.view(-1, w).index_copy_(0, slots, rows.to(cache.dtype))


def gather_pages(cache: torch.Tensor, block_tables: torch.Tensor, n_kv: int) -> torch.Tensor:
    """Gather per-sequence K or V: [pages, ps, W] x [B, N] -> [B, N*ps, kv, hd]."""
    b, n = block_tables.shape
    _, ps, w = cache.shape
    gathered = cache[block_tables.reshape(-1).long()]  # [B*N, ps, W]
    return gathered.reshape(b, n * ps, n_kv, w // n_kv)


def paged_attention_reference(
    q: torch.Tensor,  # [B, T, n_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, page_size, n_kv * head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_per_seq]
    positions: torch.Tensor,  # i32[B, T]
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal paged attention (gather formulation); returns [B, T, H, hd].

    Causal masking is ``key_pos <= query_pos`` with key position the index in
    the gathered page order. Padding query rows produce values callers discard."""
    b, t, n_heads, head_dim = q.shape
    n_kv = k_cache.shape[2] // head_dim
    group = n_heads // n_kv
    if scale is None:
        scale = head_dim**-0.5
    k = gather_pages(k_cache, block_tables, n_kv)  # [B, S, n_kv, hd]
    v = gather_pages(v_cache, block_tables, n_kv)
    s = k.shape[1]
    if k.dtype.itemsize < 2:  # fp8 KV cache: matmuls run in the query dtype, as in the JAX build
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = (q * scale).to(q.dtype).reshape(b, t, n_kv, group, head_dim)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    key_pos = torch.arange(s, device=q.device, dtype=torch.int32)
    mask = key_pos[None, None, :] <= positions[:, :, None]  # [B, T, S]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", weights.to(v.dtype).float(), v.float())
    return out.reshape(b, t, n_heads, head_dim).to(q.dtype)


def write_kv(
    k_cache: torch.Tensor,  # [num_pages, page_size, n_kv * head_dim]
    v_cache: torch.Tensor,
    new_k: torch.Tensor,  # [B, T, n_kv, head_dim]
    new_v: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T] flat slot = page_id * page_size + offset (0 for padding)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V into the paged cache **in place** (:func:`store_rows`
    on the flat ``[pages * ps, W]`` view) and return the same cache tensors.
    Padding tokens carry slot 0 (the null page): their overlapping writes are
    harmless."""
    w = k_cache.shape[-1]
    slots = slot_mapping.reshape(-1).long()
    store_rows(k_cache, slots, new_k.reshape(-1, w))
    store_rows(v_cache, slots, new_v.reshape(-1, w))
    return k_cache, v_cache


def noncontiguous_rows(positions: np.ndarray) -> list[int]:
    """Rows of a host ``positions`` array that break the prefill kernel's
    contract: a contiguous run starting anywhere, padded with trailing zeros
    (pure-padding rows are all zeros)."""
    bad = []
    for i, row in enumerate(np.asarray(positions)):
        nz = np.nonzero(row)[0]
        last = int(nz[-1]) if nz.size else 0
        if not ((np.diff(row[: last + 1]) == 1).all() and not row[last + 1:].any()):
            bad.append(i)
    return bad


def attention_phase(t: int, contiguous_positions: bool) -> str:
    """The phase the dispatch takes for a T-token step: ``decode`` (T == 1),
    ``verify`` (gappy T > 1, the decode kernel's multi-query form) or
    ``prefill`` (contiguous T > 1). Pure shape logic: the runner records it
    per step without touching tensors."""
    if t == 1:
        return "decode"
    return "prefill" if contiguous_positions else "verify"


def paged_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
    contiguous_positions: bool = True,
) -> torch.Tensor:
    """Dispatching paged attention (see the module docstring).

    ``contiguous_positions`` declares that every real row of ``positions``
    steps by exactly 1 (engine prefill, chunked or not); callers with gappy
    rows (speculative verify) must pass False. The declaration is verified
    when ``positions`` lies on the CPU; the runner verifies its host copy
    before every device step."""
    t = q.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if t > 1 and contiguous_positions and positions.device.type == "cpu":
        bad = noncontiguous_rows(positions.numpy())
        if bad:
            raise ValueError(
                f"paged_attention: positions are not per-row contiguous (rows {bad}); "
                f"pass contiguous_positions=False for gappy layouts"
            )
    if attention_phase(t, contiguous_positions) == "prefill":
        from dynamo_tpu_torch.ops.paged_prefill import paged_prefill_attention

        return paged_prefill_attention(q, k_cache, v_cache, block_tables, positions, scale=scale)
    from dynamo_tpu_torch.ops.paged_decode import paged_decode_attention

    return paged_decode_attention(q, k_cache, v_cache, block_tables, positions, scale=scale)
