"""Distributed training support (port of ``paddle_tpu.distributed``), one
process so far: the durable checkpoint layer (``checkpoint``). The mesh,
the collectives, the consistency check and the launcher are not
ported."""
from . import checkpoint
from .checkpoint import (AsyncCheckpointManager, CheckpointError,
                         CheckpointManager, load_state_dict, save_state_dict,
                         verify_checkpoint)

__all__ = ["checkpoint", "save_state_dict", "load_state_dict",
           "verify_checkpoint", "CheckpointError", "CheckpointManager",
           "AsyncCheckpointManager"]
