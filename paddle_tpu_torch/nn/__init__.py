"""The nn API (port of ``paddle_tpu.nn``): the attention functionals and
the transformer layers (``layer.transformer``), built from ``torch.nn``
modules."""
from . import functional, layer
from .layer import (MultiHeadAttention, Transformer, TransformerDecoder,
                    TransformerDecoderLayer, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "layer", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
