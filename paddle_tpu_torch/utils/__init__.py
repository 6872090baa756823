"""Utilities: weight conversion from the JAX package's state."""
from .convert import from_paddle_tpu_state

__all__ = ["from_paddle_tpu_state"]
