"""Utilities: weight conversion from the JAX package's state and one
rank's shards of it under a mesh layout, nested parameter dicts as
trees, the fault-injection points the trainer's
anomaly guard and preemption path are drilled with, and the preemption
guard."""
from . import fault_injection, preemption, tree
from .convert import (from_gpt_params, from_llama_params, from_llama_state,
                      from_paddle_tpu_state, shard_params, unshard_params)

__all__ = ["fault_injection", "preemption", "tree", "from_gpt_params",
           "from_paddle_tpu_state", "from_llama_params", "from_llama_state",
           "shard_params", "unshard_params"]
