"""Speculative decoding: the drafter side of the draft->verify->accept
loop (port of ``paddle_tpu.serving.spec_decode``, the same behaviour).

Speculative decoding (Leviathan et al. 2023; Chen et al. 2023) amortizes
the per-tick weight read over ``k`` drafted tokens verified in ONE
batched forward, and with greedy acceptance it is *output-identical*:
the committed tokens are always the verify step's own argmax choices, so
a speculative run reproduces the non-speculative continuation token for
token.

This module is the pluggable HOST side: a :class:`Drafter` proposes up
to ``max_tokens`` continuation tokens for a request's context; the
scheduler feeds ``[last_token, draft...]`` through the engine's
``verify`` step (the paged multi-query kernel, K-MQ) and accepts the
longest matching prefix plus one bonus token. :class:`NgramDrafter` is
the zero-model **prompt-lookup** drafter: match the context's own
trailing n-gram against its earlier occurrences and propose the
continuation that followed last time. It pays on repetitious/templated
traffic; on i.i.d.-random continuations its acceptance is ~0 by
construction.

The truncation contract (enforced here AND re-clamped by the scheduler):
``propose`` never returns more than ``max_tokens`` tokens. The scheduler
passes the request's remaining budget minus one (the bonus token the
verify step always contributes), and zero once the deadline has passed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

__all__ = ["SpecDecodeConfig", "Drafter", "NgramDrafter"]


@dataclasses.dataclass
class SpecDecodeConfig:
    """Scheduler-facing speculative-decoding knobs.

    ``k`` is the maximum drafted tokens per tick — the verify window is
    ``k + 1`` rows and is STATIC per scheduler (K-MQ takes windows of up
    to 8 rows, so ``k <= 7`` on the card). ``max_ngram`` /
    ``min_ngram`` bound the suffix lengths the n-gram drafter tries
    (longest first: a longer match is stronger evidence the continuation
    will repeat)."""

    k: int = 4
    max_ngram: int = 3
    min_ngram: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec decode k must be >= 1, got {self.k}")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{self.min_ngram}..{self.max_ngram}")


class Drafter:
    """The pluggable drafter contract. ``propose(tokens, max_tokens)``
    returns up to ``max_tokens`` speculative continuation token ids for
    a request whose full context (prompt + generated so far) is
    ``tokens``; an empty list means "no speculation this tick" (the
    verify step degenerates to a plain decode). Implementations MUST
    honor ``max_tokens`` — the scheduler clamps defensively, but a
    well-behaved drafter never drafts past a request's remaining budget
    or deadline. A small draft *model* slots in here later: its
    ``propose`` would run its own decode loop."""

    def propose(self, tokens: Sequence[int],
                max_tokens: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Zero-model prompt-lookup drafter: suffix-match the context's own
    trailing ``n``-gram (``max_ngram`` down to ``min_ngram``, longest
    match wins; among equal lengths the LATEST earlier occurrence wins —
    recency tracks the current generation loop) and propose the tokens
    that followed that occurrence. Pure host-side; O(len · ngram) per
    propose over contexts capped at ``max_model_len``."""

    def __init__(self, k: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1):
        self.cfg = SpecDecodeConfig(k=k, max_ngram=max_ngram,
                                    min_ngram=min_ngram)

    def propose(self, tokens: Sequence[int],
                max_tokens: int) -> List[int]:
        limit = min(self.cfg.k, int(max_tokens))
        n_tok = len(tokens)
        if limit <= 0 or n_tok < self.cfg.min_ngram + 1:
            return []
        tokens = list(tokens)
        hi = min(self.cfg.max_ngram, n_tok - 1)
        for n in range(hi, self.cfg.min_ngram - 1, -1):
            suffix = tokens[-n:]
            # latest earlier occurrence wins (recency tracks the
            # current generation loop). A match ``d`` tokens back is
            # evidence of a period-``d`` repetition: when d >= limit
            # the continuation is read off verbatim (classic prompt
            # lookup); when d < limit the raw continuation runs into
            # the suffix itself and truncates, so extrude it
            # cyclically with period d — a flush match (d == 1)
            # proposes ``limit`` copies of the last token, exactly the
            # period-1 loop hypothesis.
            for start in range(n_tok - n - 1, -1, -1):
                if tokens[start:start + n] == suffix:
                    d = (n_tok - n) - start
                    base = tokens[start + n:]
                    return [base[i % d] for i in range(limit)]
        return []
