"""Distributed training support (port of ``paddle_tpu.distributed``):
the hybrid mesh over a ``torch.distributed`` world (``mesh``), the
collectives and their autograd forms (``communication``), and the
durable checkpoint layer (``checkpoint``, one rank). The launcher, the
consistency check and multi-rank checkpoints are not ported."""
from . import checkpoint, communication, mesh
from .checkpoint import (AsyncCheckpointManager, CheckpointError,
                         CheckpointManager, load_state_dict, save_state_dict,
                         verify_checkpoint)
from .mesh import Mesh, build_mesh, get_mesh, mesh_context

__all__ = ["checkpoint", "communication", "mesh", "save_state_dict",
           "load_state_dict", "verify_checkpoint", "CheckpointError",
           "CheckpointManager", "AsyncCheckpointManager", "Mesh",
           "build_mesh", "get_mesh", "mesh_context"]
