"""Model families (port of ``paddle_tpu.models``): GPT, LLaMA and BERT."""
from . import bert, gpt, llama
from .bert import (
    BertConfig,
    BertForPretraining,
    BertModel,
    bert_base,
    bert_large,
)
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

__all__ = ["bert", "gpt", "llama", "BertConfig", "BertModel",
           "BertForPretraining", "bert_base", "bert_large", "GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_345m", "gpt_1p3b",
           "LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_7b"]
