"""Distributed training support (port of ``paddle_tpu.distributed``):
the rank's environment (``env``: ``init_parallel_env``), the launcher
and its watcher (``launch``: ``python -m
paddle_tpu_torch.distributed.launch``), the elastic manager
(``fleet.elastic``), the hybrid mesh over a ``torch.distributed`` world
(``mesh``), the collectives and their autograd forms
(``communication``) with the flight recorder (``collective_runtime``),
the cross-rank consistency check (``consistency``), and durable
checkpoints from one process or every rank (``checkpoint``)."""
from . import (checkpoint, collective_runtime, communication, consistency,
               env, fleet, launch, mesh)
from .checkpoint import (AsyncCheckpointManager, CheckpointError,
                         CheckpointManager, Sharded, load_state_dict,
                         save_state_dict, verify_checkpoint)
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .mesh import Mesh, build_mesh, get_mesh, mesh_context

__all__ = ["checkpoint", "collective_runtime", "communication",
           "consistency", "env", "fleet", "launch", "mesh",
           "save_state_dict", "load_state_dict", "verify_checkpoint",
           "CheckpointError", "CheckpointManager", "AsyncCheckpointManager",
           "Sharded", "Mesh", "build_mesh", "get_mesh", "mesh_context",
           "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv"]
