"""Functionals (port of ``paddle_tpu.nn.functional``): attention."""
from . import attention
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sequence_mask)

__all__ = ["attention", "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sequence_mask"]
