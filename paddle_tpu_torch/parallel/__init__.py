"""Training (port of ``paddle_tpu.parallel``), one device so far: the
functional GPT core over stacked parameters (``transformer_core``) and
the trainer with AdamW and the in-step anomaly guard (``hybrid``). The
mesh, tensor/pipeline/sequence parallelism and ZeRO are not ported."""
from . import hybrid, transformer_core
from .hybrid import (
    DIVERGENCE_EXIT_CODE,
    HybridParallelTrainer,
    NumericalDivergenceError,
    TrainerConfig,
)
from .transformer_core import gpt_forward, gpt_init, gpt_loss

__all__ = ["hybrid", "transformer_core", "DIVERGENCE_EXIT_CODE",
           "HybridParallelTrainer", "NumericalDivergenceError",
           "TrainerConfig", "gpt_init", "gpt_forward", "gpt_loss"]
