"""Fused layers (port of ``paddle_tpu.incubate.nn``)."""
from .layer import (  # noqa: F401
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer"]
