"""Paged-KV serving: bucketing, the page pool, the engine, the
continuous-batching scheduler, load generation, tenancy, and the replica
fleet with its router and disaggregated prefill/decode (port of
``paddle_tpu.serving``)."""
from .bucketing import bucket_count, bucket_for
from .disagg import DisaggCoordinator
from .engine import ServingConfig, ServingEngine
from .kv_cache import (
    PagedForwardState,
    PagedKVCache,
    PagedLayerView,
    PagePool,
    PagesExhausted,
    copy_pages,
    plan_kv_pool,
)
from .loadgen import (
    RetryPolicy,
    long_prompt_trace,
    multi_tenant_trace,
    repetitious_trace,
    run_continuous,
    run_static_baseline,
    synthetic_trace,
)
from .replica import Replica, ReplicaDown
from .router import LogicalRequest, ReplicaRouter, RouterConfig
from .scheduler import ContinuousBatchingScheduler, RejectedError, Request
from .spec_decode import Drafter, NgramDrafter, SpecDecodeConfig
from .tenancy import Tenant, TenantRegistry, TenantSLOView, TokenBucket

__all__ = [
    "bucket_for", "bucket_count",
    "PagePool", "PagedKVCache", "PagedForwardState", "PagedLayerView",
    "PagesExhausted", "plan_kv_pool", "copy_pages",
    "Drafter", "NgramDrafter", "SpecDecodeConfig",
    "ServingConfig", "ServingEngine",
    "ContinuousBatchingScheduler", "Request", "RejectedError",
    "synthetic_trace", "run_continuous", "run_static_baseline",
    "repetitious_trace", "long_prompt_trace", "multi_tenant_trace",
    "RetryPolicy",
    "Tenant", "TenantRegistry", "TokenBucket", "TenantSLOView",
    "Replica", "ReplicaDown",
    "ReplicaRouter", "RouterConfig", "LogicalRequest",
    "DisaggCoordinator",
]
