"""Incubating APIs (port of ``paddle_tpu.incubate``): the fused
transformer layers."""
from . import nn

__all__ = ["nn"]
