"""Synthetic load generation (port of ``paddle_tpu.serving.loadgen``,
``repetitious_trace`` only).

``repetitious_trace`` is the speculative-decoding traffic family: each
prompt tiles one request-specific random phrase several times, the
templated/boilerplate content where prompt-lookup speculation pays. It
draws from numpy's ``RandomState(seed)`` in the JAX package's order, so
both packages replay the identical trace per seed.

Not ported yet: ``synthetic_trace``, ``long_prompt_trace``,
``multi_tenant_trace``, ``prompt_length_report``, ``run_continuous``,
``run_static_baseline`` and ``RetryPolicy``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .scheduler import Request

__all__ = ["repetitious_trace"]


def repetitious_trace(n_requests: int, seed: int = 0,
                      rate_rps: Optional[float] = None,
                      phrase_lens=(6, 12), repeats=(3, 6),
                      out_tokens=(32, 80), vocab_size: int = 1024,
                      deadline_s: Optional[float] = None
                      ) -> List[Request]:
    """``n_requests`` requests whose prompts tile a random phrase of
    ``phrase_lens`` tokens ``repeats`` times, with ``out_tokens`` new
    tokens each (all ranges inclusive). Poisson arrivals at ``rate_rps``
    (``None``: everything at t=0), deterministic per seed."""
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        if rate_rps:
            t += float(rng.exponential(1.0 / rate_rps))
        phrase = rng.randint(
            0, vocab_size,
            int(rng.randint(phrase_lens[0], phrase_lens[1] + 1)))
        reps = int(rng.randint(repeats[0], repeats[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=np.tile(phrase, reps).astype(np.int32),
            max_new_tokens=int(rng.randint(out_tokens[0],
                                           out_tokens[1] + 1)),
            arrival_s=t, deadline_s=deadline_s))
    return reqs
