"""Attention dispatch and the hand-written Hopper kernels."""
from . import attention_dispatch, kernels

__all__ = ["attention_dispatch", "kernels"]
