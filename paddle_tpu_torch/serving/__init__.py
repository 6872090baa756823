"""Paged-KV serving: bucketing, the page pool, the engine and the
continuous-batching scheduler (port of ``paddle_tpu.serving``)."""
from .bucketing import bucket_count, bucket_for
from .engine import ServingConfig, ServingEngine
from .kv_cache import (
    PagedForwardState,
    PagedKVCache,
    PagedLayerView,
    PagePool,
    PagesExhausted,
)
from .loadgen import repetitious_trace
from .scheduler import ContinuousBatchingScheduler, RejectedError, Request
from .spec_decode import Drafter, NgramDrafter, SpecDecodeConfig

__all__ = [
    "bucket_for", "bucket_count", "ServingConfig", "ServingEngine",
    "PagePool", "PagesExhausted", "PagedKVCache", "PagedForwardState",
    "PagedLayerView", "ContinuousBatchingScheduler", "Request",
    "RejectedError", "SpecDecodeConfig", "Drafter", "NgramDrafter",
    "repetitious_trace",
]
