"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The package mirrors ``paddle_tpu``'s module paths so each file has one
obvious counterpart, but imports only ``torch`` (and numpy): never
``jax`` and nothing of ``paddle_tpu``. Every Pallas kernel on a ported
path is a CUDA kernel written by hand for ``sm_90a`` under
``csrc/``, built with ``nvcc`` on first use (``ops/kernels/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``"cpu"`` they raise.

Ported so far: GPT paged serving (``models.gpt``, ``serving``), the
single-device GPT training step (``parallel``) with packed sequences
(``io.packing``), training through the nn API (``GPTForCausalLM`` with
``GPTPretrainingCriterion``), and their ten attention kernels
(``ops.kernels``). The rest of the Paddle API surface is not ported yet.
"""
from . import device, io, models, ops, parallel, serving, utils

__all__ = ["device", "io", "models", "ops", "parallel", "serving", "utils"]
