"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The package mirrors ``paddle_tpu``'s module paths so each file has one
obvious counterpart, but imports only ``torch`` (and numpy): never
``jax`` and nothing of ``paddle_tpu``. Every Pallas kernel on a ported
path is a CUDA kernel written by hand for ``sm_90a`` under
``csrc/``, built with ``nvcc`` on first use (``ops/kernels/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``"cpu"`` they raise.

Ported so far: GPT and LLaMA paged serving (``models``, ``serving``),
the training step (``parallel``) on one device or over a mesh of
``torch.distributed`` ranks (data, ZeRO, tensor and sequence
parallelism: ``distributed.mesh``, ``distributed.communication``,
``ops.ring_attention``), launched and made durable over ranks
(``distributed.launch``, ``distributed.env``, ``distributed.consistency``,
multi-rank ``distributed.checkpoint``), with packed sequences
(``io.packing``), remat policies, loss scaling, checkpoints and
preemption, training through the nn API
(``GPTForCausalLM`` with ``GPTPretrainingCriterion``), run telemetry and
the ops endpoint (``observability``), the BERT encoder
(``models.bert``) with ``nn.functional``'s attention (full and varlen),
and their thirteen attention kernels (``ops.kernels``), which take
attention dropout and additive masks; the transformer layers
(``nn.layer.transformer``, ``incubate.nn``) and the random stream
(``framework.random``; ``seed``, ``get_rng_state`` and ``set_rng_state``
here, as in the JAX package). The rest of the Paddle API surface is not
ported yet.
"""
from . import (device, distributed, framework, incubate, io, models, nn,
               observability, ops, parallel, serving, utils)
from .framework.random import get_rng_state, seed, set_rng_state

__all__ = ["device", "distributed", "framework", "incubate", "io", "models",
           "nn", "observability", "ops", "parallel", "serving", "utils",
           "seed", "get_rng_state", "set_rng_state"]
