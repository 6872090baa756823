from .fused_transformer import (  # noqa: F401
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)
