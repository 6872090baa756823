"""Model families (port of ``paddle_tpu.models``): GPT and LLaMA."""
from . import gpt, llama
from .gpt import (
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    GPTPretrainingCriterion,
    gpt_1p3b,
    gpt_345m,
    gpt_tiny,
)
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    llama_7b,
    llama_tiny,
)

__all__ = ["gpt", "llama", "GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_345m", "gpt_1p3b",
           "LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_7b"]
