"""Draft-token proposers for speculative decoding (a copy of
``dynamo_tpu/engine/spec.py`` whose n-gram scan is vectorized with numpy:
the same drafts, held against the JAX build's in ``tests/test_torch_spec.py``).

The engine treats a proposer as a black box that, given a request's full
token history (prompt + generated), suggests up to ``max_k`` continuation
tokens. Proposals are *speculative*: the verify dispatch scores them against
the target model and the scheduler only commits the accepted prefix, so a
proposer can be arbitrarily wrong without affecting output correctness —
only throughput.

The default proposer is the n-gram / prompt-lookup drafter (Saxena 2023):
match the longest recent suffix of the history against an earlier
occurrence and propose whatever followed it. It is deterministic,
model-free, and costs O(len(history)) per call on the host, which makes the
whole speculative path CPU-testable. A draft-model proposer can slot in
behind the same interface later.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Proposer(Protocol):
    """Interface the engine drafts through."""

    def propose(self, tokens: Sequence[int], max_k: int) -> list[int]:
        """Return up to ``max_k`` draft tokens continuing ``tokens``.

        ``tokens`` is the request's prompt + generated history in order.
        Must be deterministic for a given history (losslessness does not
        require it, but reproducible benchmarks do).
        """
        ...


class NgramProposer:
    """Prompt-lookup drafting: find an earlier occurrence of the history's
    trailing n-gram and propose the tokens that followed it.

    Tries match lengths from ``max_ngram`` down to ``min_ngram`` and takes
    the longest suffix that matches. Among equal-length matches, the most
    recent occurrence with a *full* ``max_k`` continuation wins (recent
    context predicts continuation best); if every match sits too close to
    the end for a full draft — the period-1 repetition case — the longest
    available continuation is used instead of giving up draft length.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: Sequence[int], max_k: int) -> list[int]:
        """The JAX build's scan, vectorized: for each match length, every
        earlier start is compared at once (numpy), then the most recent
        start with a full ``max_k`` continuation wins, else the one with the
        longest (the earliest start). Same drafts, a fraction of the host
        time on long histories."""
        n = len(tokens)
        if max_k <= 0 or n < self.min_ngram + 1:
            return []
        toks = np.asarray(tokens, dtype=np.int64)
        for length in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            starts = n - length  # candidate starts 0 .. n - length - 1
            match = np.ones(starts, dtype=bool)
            for i in range(length):
                match &= toks[i:i + starts] == toks[n - length + i]
            hits = np.flatnonzero(match)
            if not hits.size:
                continue
            full = hits[hits <= n - length - max_k]
            start = int(full[-1]) if full.size else int(hits[0])
            return toks[start + length:start + length + max_k].tolist()
        return []


def build_proposer(name: str = "ngram") -> Proposer:
    """Factory keyed by proposer name (currently only ``ngram``)."""
    if name == "ngram":
        return NgramProposer()
    raise ValueError(f"unknown speculative proposer: {name!r}")
