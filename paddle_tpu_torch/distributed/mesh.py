"""The hybrid mesh over an initialised ``torch.distributed`` world (port
of ``paddle_tpu.distributed.mesh``).

The JAX package names its axes on one ``jax.sharding.Mesh`` and lets
GSPMD place every collective. Here the world is explicit: every rank is
one process, and :func:`build_mesh` lays the world out on the same six
axes in the same order, ``("data", "pipe", "sharding", "expert", "sep",
"model")``, tensor parallelism innermost. Rank r's coordinates are the
row-major index of r over the axis sizes, so rank r holds what the JAX
mesh's r-th device holds. The mesh builds one ``ProcessGroup`` per axis
of size > 1 and per combination the trainer reduces over (``GROUP_AXES``:
the batch axes ``("data", "sharding")``, ``("data", "sep")`` and
``("data", "sharding", "sep")``); a group of one rank is None and every
collective over it is the identity.

The collective backend is the caller's choice, made when it initialised
the world: ``"nccl"`` (one card per rank) or ``"gloo"`` (the CPU, or
ranks that share one card). PyTorch's backend table lists only
``all_reduce`` and ``broadcast`` as gloo operations on CUDA tensors; the
installed gloo also gathers and reduce-scatters them (each through its
own host copy), but a send or receive of a CUDA tensor aborts the
process (gloo writes the device pointer to its socket). A mesh of gloo
ranks on a CUDA device therefore stages its sends and receives through
pinned host buffers. That mesh says so in its ``repr`` and in
``host_staged``, which its callers pass to ``communication``'s
point-to-point calls; without it a CUDA send or receive over gloo
raises.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["AXES", "GROUP_AXES", "PartitionSpec", "P", "Mesh", "build_mesh",
           "mesh_context", "get_mesh"]

AXES = ("data", "pipe", "sharding", "expert", "sep", "model")

# the axis combinations that get a group of their own besides each axis
GROUP_AXES = (("data", "sharding"), ("data", "sep"),
              ("data", "sharding", "sep"))

_tls = threading.local()


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    axis names (major to minor), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Mesh:
    """This rank's view of the hybrid mesh: the axis sizes (``shape``),
    its coordinates, its device, the backend, and the process groups.

    ``group(axes)`` is the group of the ranks that differ from this one
    only along ``axes`` (None when that is this rank alone);
    ``size(axes)`` and ``coord(axes)`` are the group's size and this
    rank's row-major index in it; ``rank_at(**coords)`` is the global
    rank at this rank's coordinates with some replaced."""

    def __init__(self, sizes: Dict[str, int], rank: int, backend: str,
                 device: torch.device, groups: Dict[Tuple[str, ...], object]):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.axis_names = AXES
        self.rank = rank
        self.world = math.prod(self.shape.values())
        self.backend = backend
        self.device = device
        self.host_staged = backend == "gloo" and device.type == "cuda"
        self.coords = dict(zip(AXES, _unravel(rank, self.shape)))
        self._groups = groups
        self.world_group = dist.group.WORLD if self.world > 1 else None

    def size(self, axes) -> int:
        n = 1
        for a in _names(axes):
            n *= self.shape[a]
        return n

    def coord(self, axes) -> int:
        c = 0
        for a in _names(axes):
            c = c * self.shape[a] + self.coords[a]
        return c

    def group(self, axes):
        key = tuple(a for a in AXES if a in _names(axes))
        if self.size(key) == 1:
            return None
        if key not in self._groups:
            raise KeyError(f"mesh has no group over {key}; groups are built "
                           f"for each axis and {GROUP_AXES}")
        return self._groups[key]

    def rank_at(self, **coords) -> int:
        c = dict(self.coords, **coords)
        r = 0
        for a in AXES:
            r = r * self.shape[a] + c[a] % self.shape[a]
        return r

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        staged = ("; host-staged send/recv (pinned buffers)"
                  if self.host_staged else "")
        return (f"Mesh({axes}; rank {self.rank} of {self.world}; backend "
                f"{self.backend}; device {self.device}{staged})")



def _unravel(rank: int, shape: Dict[str, int]):
    out = []
    for a in reversed(AXES):
        out.append(rank % shape[a])
        rank //= shape[a]
    return tuple(reversed(out))


def build_mesh(dp: int = 1, pp: int = 1, sharding: int = 1, mp: int = 1,
               sep: int = 1, ep: int = 1, device=None) -> Mesh:
    """The hybrid mesh over the initialised world, whose size must be
    ``dp * pp * sharding * ep * sep * mp``. Every rank must call it, in
    the same order as its other group constructions: it creates the
    groups collectively. ``device`` is this rank's device (default: the
    current CUDA device; ``"cpu"`` for the CPU). The groups use the
    world's backend, which must be ``"nccl"`` or ``"gloo"``."""
    from ..device import resolve_device

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised torch.distributed world: call "
            "torch.distributed.init_process_group(backend='nccl' or "
            "'gloo', init_method=..., world_size=..., rank=...) first")
    sizes = {"data": dp, "pipe": pp, "sharding": sharding, "expert": ep,
             "sep": sep, "model": mp}
    if any(int(n) < 1 for n in sizes.values()):
        raise ValueError(f"mesh axis sizes must be >= 1: {sizes}")
    n = math.prod(int(v) for v in sizes.values())
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {sizes} needs {n} ranks, the world has "
                         f"{world}")
    backend = str(dist.get_backend())
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"mesh backend must be 'nccl' or 'gloo', the world "
                         f"was initialised with {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs a CUDA device per rank")
    rank = dist.get_rank()
    shape = {a: int(sizes[a]) for a in AXES}
    keys = [(a,) for a in AXES] + [tuple(k) for k in GROUP_AXES]
    groups: Dict[Tuple[str, ...], object] = {}
    built: Dict[Tuple[int, ...], object] = {}
    all_coords = [_unravel(r, shape) for r in range(world)]
    for key in keys:
        if key in groups:
            continue
        if math.prod(shape[a] for a in key) == 1:
            continue
        idx = [AXES.index(a) for a in key]
        others = [i for i in range(len(AXES)) if i not in idx]
        # one group per setting of the other axes, in row-major order:
        # every rank constructs every group, the same sequence everywhere
        by_rest: Dict[tuple, list] = {}
        for r, c in enumerate(all_coords):
            by_rest.setdefault(tuple(c[i] for i in others), []).append(r)
        mine = None
        for rest in sorted(by_rest):
            ranks = tuple(by_rest[rest])
            g = built.get(ranks)
            if g is None:
                g = built[ranks] = dist.new_group(list(ranks),
                                                  backend=backend)
            if rank in ranks:
                mine = g
        groups[key] = mine
    return Mesh(sizes, rank, backend, dev, groups)


class mesh_context:
    """Makes ``mesh`` the ambient mesh (``get_mesh``) inside a ``with``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _tls.stack.pop()


def get_mesh() -> Optional[Mesh]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None
