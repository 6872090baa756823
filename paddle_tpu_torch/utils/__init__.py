"""Utilities: weight conversion from the JAX package's state, nested
parameter dicts as trees, and the fault-injection point the trainer's
anomaly guard is drilled with."""
from . import fault_injection, tree
from .convert import (from_gpt_params, from_llama_params, from_llama_state,
                      from_paddle_tpu_state)

__all__ = ["fault_injection", "tree", "from_gpt_params",
           "from_paddle_tpu_state", "from_llama_params", "from_llama_state"]
