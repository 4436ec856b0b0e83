"""Batched token sampling: greedy / temperature / top-k / top-p / penalties
(counterpart of ``dynamo_tpu/ops/sampling.py``).

Greedy rows are an exact full-row argmax. Non-greedy rows work inside a
``CANDIDATES``-wide window (``torch.topk``; the TPU build's
``approx_max_k`` is exact on CPU), where temperature, top-k, top-p and the
OpenAI frequency/presence penalties apply. The categorical draw is
``argmax(scaled + gumbel)`` — what ``jax.random.categorical`` computes —
with the Gumbel noise passed in, so a test can feed both builds the same
noise. :func:`gumbel_noise` draws what the JAX runner draws: row i's key is
``fold_in(PRNGKey(seeds[i]), sample_steps[i])`` and its noise
``jax.random.gumbel(key, (width,))`` (the ``categorical`` draw of
``sample_tokens``), computed here with threefry-2x32 written in PyTorch on
the rows' device, all rows at once. A seeded request's tokens depend on
``(seed, sample_steps)`` alone, never on what it is batched with.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import NEG_INF

# Candidate window for non-greedy sampling (covers every practical top-k and
# >0.999 of nucleus mass for peaked LLM distributions).
CANDIDATES = 256


# threefry-2x32 (jax/_src/prng.py _threefry2x32_lowering): 20 rounds in five
# groups of four rotations, a key injection after each group.
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))  # maxval - minval, in f32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash of counters ``(x0, x1)`` under key ``(k0, k1)``:
    int64 tensors holding uint32 values, broadcast together; returns the two
    output words the same way. Every sum is masked back to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def random_bits(seeds: torch.Tensor, sample_steps: torch.Tensor, width: int) -> torch.Tensor:
    """uint32 words (as int64) ``[B, width]``: row i is
    ``jax.random.bits(fold_in(PRNGKey(seeds[i]), sample_steps[i]), (width,))``
    with the partitionable threefry of jax 0.9 (counters ``(0, iota)``, a
    word the xor of the hash's two outputs). ``seeds``/``sample_steps``:
    integer tensors ``[B]``, read as uint32 (the runner packs them as
    int32)."""
    seed = seeds.long()[:, None] & _MASK32
    step = sample_steps.long()[:, None] & _MASK32
    zero = torch.zeros_like(seed)
    # PRNGKey(seed) = (0, seed); fold_in hashes the counter pair (0, data).
    k0, k1 = threefry2x32(zero, seed, zero, step)
    iota = torch.arange(width, device=seeds.device, dtype=torch.int64)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(iota), iota)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms on ``[tiny, 1)`` from 32-bit words, as
    ``jax.random.uniform(minval=tiny, maxval=1)`` builds them: the top 23
    bits as the mantissa of a float in ``[1, 2)``, minus 1, scaled and
    shifted, then at least ``tiny``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # Python scalars, each an exact f32 value, so nothing is copied to the
    # device (a step may be captured in a CUDA graph): the f32 products and
    # sums are those of f32 tensors.
    return torch.clamp(mant * _SPAN + _TINY, min=_TINY)


def gumbel_noise(seeds: torch.Tensor, sample_steps: torch.Tensor, temperature: torch.Tensor,
                 width: int) -> torch.Tensor:
    """f32 ``[B, width]`` standard Gumbel noise on the inputs' device: row i
    is ``jax.random.gumbel(fold_in(PRNGKey(seeds[i]), sample_steps[i]),
    (width,))`` (its ``mode="low"`` form, ``-log(-log(u))``). Greedy rows
    (temperature 0) get zeros — they never read it."""
    u = uniform_from_bits(random_bits(seeds, sample_steps, width))
    return torch.where(temperature[:, None] > 0, -torch.log(-torch.log(u)), 0.0)


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
    all_greedy: bool | None = None,
) -> torch.Tensor:
    """Sample one token per row; returns i32[B].

    Penalties follow the OpenAI semantics over generated tokens
    (``logit -= freq * count + pres * (count > 0)``), counted inside the
    candidate window; a penalized greedy row takes the penalized window
    argmax. ``gumbel=None`` is allowed only when every row is greedy:
    ``all_greedy`` is what the caller knows of that (the runner decides it
    on the host, so a captured step never reads ``temperature`` back);
    None checks ``temperature``, which waits for the device."""
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
        if all_greedy is None:
            all_greedy = not bool((temperature > 0).any())
        if not all_greedy:
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
