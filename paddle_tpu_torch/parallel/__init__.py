"""Training (port of ``paddle_tpu.parallel``), one device so far: the
functional GPT core (``transformer_core``) and LLaMA core
(``llama_core``) over stacked parameters, and the trainer with AdamW, the
in-step anomaly guard and loss scaler, checkpoints, preemption and
divergence rollback (``hybrid``). The mesh, tensor/pipeline/sequence
parallelism and ZeRO are not ported."""
from . import hybrid, llama_core, transformer_core
from .hybrid import (
    DIVERGENCE_EXIT_CODE,
    HybridParallelTrainer,
    NumericalDivergenceError,
    PREEMPTED_EXIT_CODE,
    PreemptionGuard,
    TrainerConfig,
    TrainingPreempted,
)
from .llama_core import llama_init, llama_loss
from .transformer_core import gpt_forward, gpt_init, gpt_loss

__all__ = ["hybrid", "llama_core", "transformer_core", "DIVERGENCE_EXIT_CODE",
           "HybridParallelTrainer", "NumericalDivergenceError",
           "PREEMPTED_EXIT_CODE", "PreemptionGuard", "TrainingPreempted",
           "TrainerConfig", "gpt_init", "gpt_forward", "gpt_loss",
           "llama_init", "llama_loss"]
