"""Shape bucketing: a closed set of step shapes under arbitrary traffic.

Every serving-step shape (decode batch, packed prefill token count,
batch-prefill rows/length) is rounded UP to a power-of-two bucket, so
arbitrary request traffic reaches at most
``log2(max) - log2(min) + 1`` shapes per step kind. PyTorch runs eagerly
and compiles nothing per shape, but the closed set keeps the kernels'
launch shapes (and, later, captured CUDA graphs) bounded, and keeps the
port's padding identical to ``paddle_tpu.serving.bucketing``.

``bucket_for`` is the one policy point, shared by the engine, the
scheduler, and ``GPTForCausalLM.generate``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

__all__ = ["bucket_for", "bucket_count"]


def _bucket_one(n: int, minimum: int, maximum: Optional[int]) -> int:
    if n < 0:
        raise ValueError(f"bucket_for: negative size {n}")
    b = max(int(minimum), 1)
    while b < n:
        b <<= 1
    if maximum is not None and b > maximum:
        if n <= maximum:
            # the cap itself is the top bucket even when not a power of
            # two times the minimum (e.g. max_model_len 384)
            return int(maximum)
        raise ValueError(
            f"bucket_for: size {n} exceeds the maximum bucket {maximum}")
    return b


def bucket_for(shape: Union[int, Sequence[int]], minimum: int = 1,
               maximum: Optional[int] = None
               ) -> Union[int, Tuple[int, ...]]:
    """Smallest power-of-two bucket >= the size (per dimension when
    ``shape`` is a sequence), floored at ``minimum`` and capped at
    ``maximum`` (the cap is itself the top bucket; a size beyond it
    raises — the caller's admission control should have split or
    rejected first)."""
    if isinstance(shape, (tuple, list)):
        return tuple(_bucket_one(int(d), minimum, maximum) for d in shape)
    return _bucket_one(int(shape), minimum, maximum)


def bucket_count(minimum: int, maximum: int) -> int:
    """Size of the closed bucket set between ``minimum`` and
    ``maximum``."""
    n, b = 1, max(int(minimum), 1)
    while b < maximum:
        b <<= 1
        n += 1
    return n
