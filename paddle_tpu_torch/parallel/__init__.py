"""Training (port of ``paddle_tpu.parallel``): the functional GPT core
(``transformer_core``) and LLaMA core (``llama_core``) over stacked
parameters, with their tensor-parallel, ZeRO-3 and ring-attention forms
over a mesh, and the trainer with AdamW, the in-step anomaly guard and
loss scaler, checkpoints, preemption, divergence rollback and the
cross-rank consistency check at any world, and data, ZeRO 1-3, tensor,
sequence and pipeline parallelism over ranks (``hybrid``; the GPipe,
1F1B and interleaved schedules in ``pipeline``)."""
from . import hybrid, llama_core, pipeline, transformer_core
from .hybrid import (
    DESYNC_EXIT_CODE,
    DIVERGENCE_EXIT_CODE,
    DesyncError,
    HybridParallelTrainer,
    NumericalDivergenceError,
    PREEMPTED_EXIT_CODE,
    PreemptionGuard,
    TrainerConfig,
    TrainingPreempted,
)
from .llama_core import llama_init, llama_loss
from .transformer_core import gpt_forward, gpt_init, gpt_loss

__all__ = ["hybrid", "llama_core", "pipeline", "transformer_core",
           "DESYNC_EXIT_CODE", "DesyncError", "DIVERGENCE_EXIT_CODE",
           "HybridParallelTrainer", "NumericalDivergenceError",
           "PREEMPTED_EXIT_CODE", "PreemptionGuard", "TrainingPreempted",
           "TrainerConfig", "gpt_init", "gpt_forward", "gpt_loss",
           "llama_init", "llama_loss"]
