"""Batched token sampling: greedy / temperature / top-k / top-p / penalties
(counterpart of ``dynamo_tpu/ops/sampling.py``).

Greedy rows are an exact full-row argmax. Non-greedy rows work inside a
``CANDIDATES``-wide window (``torch.topk``; the TPU build's
``approx_max_k`` is exact on CPU), where temperature, top-k, top-p and the
OpenAI frequency/presence penalties apply. The categorical draw is
``argmax(scaled + gumbel)`` — what ``jax.random.categorical`` computes —
with the Gumbel noise passed in, so a test can feed both builds the same
noise. :func:`gumbel_noise` draws it per row from an explicit generator
seeded by ``(seed, sample_steps)`` alone, so a seeded request's tokens do
not depend on what it is batched with.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import NEG_INF

# Candidate window for non-greedy sampling (covers every practical top-k and
# >0.999 of nucleus mass for peaked LLM distributions).
CANDIDATES = 256


def gumbel_noise(seeds: np.ndarray, sample_steps: np.ndarray, temperature: np.ndarray,
                 width: int) -> torch.Tensor:
    """f32[B, width] standard Gumbel noise on the CPU; row i comes from a
    ``torch.Generator`` seeded with ``(seeds[i], sample_steps[i])``. Greedy
    rows (temperature 0) get zeros — they never read it."""
    out = torch.zeros((len(seeds), width), dtype=torch.float32)
    tiny = float(np.finfo(np.float32).tiny)
    for i, (seed, step, temp) in enumerate(zip(seeds, sample_steps, temperature)):
        if temp <= 0:
            continue
        gen = torch.Generator().manual_seed((int(seed) << 32) | (int(step) & 0xFFFFFFFF))
        u = torch.rand(width, generator=gen, dtype=torch.float32).clamp_(min=tiny)
        out[i] = -torch.log(-torch.log(u))
    return out


def sample_tokens(
    logits: torch.Tensor,  # f32[B, vocab]
    temperature: torch.Tensor,  # f32[B]; 0 => greedy
    top_k: torch.Tensor,  # i32[B]; <=0 => disabled
    top_p: torch.Tensor,  # f32[B]; >=1 => disabled
    *,
    gumbel: torch.Tensor | None = None,  # f32[B, min(CANDIDATES, vocab)]; needed by non-greedy rows
    history: torch.Tensor | None = None,  # i32[B, H] generated-so-far (pad -1)
    frequency_penalty: torch.Tensor | None = None,  # f32[B]
    presence_penalty: torch.Tensor | None = None,  # f32[B]
) -> torch.Tensor:
    """Sample one token per row; returns i32[B].

    Penalties follow the OpenAI semantics over generated tokens
    (``logit -= freq * count + pres * (count > 0)``), counted inside the
    candidate window; a penalized greedy row takes the penalized window
    argmax. ``gumbel=None`` is allowed only when every row is greedy."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    penalized = history is not None and frequency_penalty is not None and presence_penalty is not None
    if gumbel is None and not penalized:
        return greedy  # every row greedy: the window never matters
    cand = min(CANDIDATES, logits.shape[-1])
    top_logits, top_idx = torch.topk(logits, cand, dim=-1)  # [B, cand], descending
    if penalized:
        counts = (history[:, None, :] == top_idx[:, :, None]).sum(-1).float()
        top_logits = top_logits - (
            frequency_penalty[:, None] * counts + presence_penalty[:, None] * (counts > 0).float()
        )
        order = torch.argsort(-top_logits, dim=-1, stable=True)
        top_logits = torch.gather(top_logits, 1, order)
        top_idx = torch.gather(top_idx, 1, order)
        has_pen = (frequency_penalty != 0) | (presence_penalty != 0)
        greedy = torch.where(has_pen, top_idx[:, 0].to(torch.int32), greedy)
    if gumbel is None:
        if bool((temperature > 0).any()):
            raise ValueError("non-greedy rows need gumbel noise")
        return greedy
    safe_temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = top_logits / safe_temp[:, None]
    ranks = torch.arange(cand, device=logits.device, dtype=torch.int32)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, cand), torch.clamp(top_k, max=cand))
    scaled = torch.where(ranks < k[:, None], scaled, NEG_INF)
    # top-p: keep tokens while the mass before them is < top_p; the argmax stays.
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    keep[:, 0] = True
    scaled = torch.where(keep, scaled, NEG_INF)
    choice = torch.argmax(gumbel + scaled, dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor, k: int):
    """OpenAI-style logprobs under log-softmax of the RAW logits:
    (chosen f32[B], top_ids i32[B, k], top_lps f32[B, k])."""
    logits = logits.float()
    lps = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    chosen = torch.gather(lps, 1, tokens[:, None].long())[:, 0]
    top_lps, top_ids = torch.topk(lps, k, dim=-1)
    return chosen, top_ids.to(torch.int32), top_lps
