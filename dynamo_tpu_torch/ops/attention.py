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
    """Scatter new K/V into the paged cache **in place** (``index_copy_`` on
    the flat ``[pages * ps, W]`` view) and return the same cache tensors.
    Padding tokens carry slot 0 (the null page): their overlapping writes are
    harmless."""
    num_pages, page_size, w = k_cache.shape
    slots = slot_mapping.reshape(-1).long()
    k_cache.view(num_pages * page_size, w).index_copy_(0, slots, new_k.reshape(-1, w).to(k_cache.dtype))
    v_cache.view(num_pages * page_size, w).index_copy_(0, slots, new_v.reshape(-1, w).to(v_cache.dtype))
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
