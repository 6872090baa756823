"""Model families (port of ``paddle_tpu.models``): GPT so far."""
from . import gpt
from .gpt import (
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    GPTPretrainingCriterion,
    gpt_1p3b,
    gpt_345m,
    gpt_tiny,
)

__all__ = ["gpt", "GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_345m", "gpt_1p3b"]
