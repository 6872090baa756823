"""The rank's environment (port of ``paddle_tpu.distributed.env``).

The launcher (``python -m paddle_tpu_torch.distributed.launch``) starts
one process per rank and gives each the JAX package's ``PADDLE_*``
variables (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``, ``PADDLE_MASTER``) and
``torch.distributed``'s own (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``). :func:`init_parallel_env` reads them and
initialises ``torch.distributed`` against the launcher's master.

The backend is chosen explicitly and logged: the caller's ``backend=``;
else ``"gloo"`` on the CPU and when the ranks of this host share cards
(NCCL cannot hold two ranks of one communicator on one card), ``"nccl"``
when every local rank has a card of its own. Each rank's device is
``cuda:(local_rank % device_count)`` unless ``device="cpu"`` is asked
for; with no CUDA device and no ``"cpu"`` it raises.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "choose_backend"]

_initialized = False
_device: torch.device | None = None


def _env_int(*names, default=0) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def choose_backend(device: torch.device, local_size: int,
                   cards: int) -> str:
    """``"gloo"`` on the CPU or when ``local_size`` ranks share fewer
    ``cards``, else ``"nccl"``."""
    if device.type != "cuda" or local_size > cards:
        return "gloo"
    return "nccl"


def init_parallel_env(backend: str | None = None,
                      device=None) -> torch.device:
    """Set this rank's device and, in a world above one rank, initialise
    ``torch.distributed`` over ``tcp://$PADDLE_MASTER`` (or
    ``MASTER_ADDR:MASTER_PORT``). Returns the rank's device. Idempotent."""
    global _initialized, _device
    if _initialized:
        return _device
    rank = _env_int("PADDLE_TRAINER_ID", "RANK")
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local_rank = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK")
    local_size = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                          default=1)
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: no CUDA device; pass device='cpu' to "
                "run the ranks on the CPU (gloo)")
        cards = torch.cuda.device_count()
        dev = (torch.device(device) if device is not None
               else torch.device("cuda", local_rank % cards))
        torch.cuda.set_device(dev)
    if world > 1 and not (dist.is_available() and dist.is_initialized()):
        master = os.environ.get("PADDLE_MASTER") or (
            f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
            f"{os.environ.get('MASTER_PORT', '')}")
        if master.endswith(":"):
            raise RuntimeError("init_parallel_env: a world of "
                               f"{world} ranks needs PADDLE_MASTER or "
                               "MASTER_ADDR/MASTER_PORT (run it under "
                               "paddle_tpu_torch.distributed.launch)")
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        chosen = backend or choose_backend(dev, local_size, cards)
        why = ("caller's choice" if backend else
               "CPU ranks" if dev.type != "cuda" else
               f"{local_size} local ranks share {cards} card(s)"
               if chosen == "gloo" else
               f"{local_size} local ranks, a card each")
        print(f"[init_parallel_env] rank {rank}/{world} on {dev}: backend "
              f"{chosen} ({why}), master {master}", file=sys.stderr,
              flush=True)
        dist.init_process_group(chosen, init_method=f"tcp://{master}",
                                world_size=world, rank=rank)
    _device = dev
    _initialized = True
    return dev


def get_rank(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return _env_int("PADDLE_TRAINER_ID", "RANK")


def get_world_size(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def is_initialized() -> bool:
    return _initialized


class ParallelEnv:
    """The rank's view of the launch (the Paddle ``ParallelEnv``)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return _device.index or 0 if _device is not None else 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
