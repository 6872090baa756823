"""Attention dispatch, ring attention and the hand-written Hopper
kernels."""
from . import attention_dispatch, kernels, ring_attention

__all__ = ["attention_dispatch", "kernels", "ring_attention"]
