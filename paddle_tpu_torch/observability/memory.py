"""Device-memory accounting: state plans, live watermarks, OOM proximity
(port of ``paddle_tpu.observability.memory``).

- **state breakdown** — :func:`state_breakdown` folds a state tree
  (nested dicts of tensors or arrays) into global and per-device bytes;
  :func:`plan_state_memory` plans a whole trainer's state (params +
  AdamW moments) at a mesh layout without allocating anything: the
  params' shapes as ``meta`` tensors (``hybrid.param_shapes``, where the
  JAX package runs ``jax.eval_shape``), and the trainer's specs give
  each rank's bytes.
- **watermark** — :func:`all_devices_memory_stats` samples
  :func:`~.step_stats.device_memory_stats` across devices (max + sum)
  and degrades to None where no device has stats (the CPU).
- **OOM proximity** — :func:`oom_risk` projects live bytes + a step's
  transient bytes against the card's capacity (:func:`..hw.hbm_bytes`)
  and flags when the projection crosses a configurable fraction.

PyTorch has no compiled executable whose memory analysis could be
read, so the JAX package's ``executable_memory_plan`` has no
counterpart here: the trainer's ``memory_plan(compute_executable=True)``
measures the next step's peak on the card instead.

Everything here is accounting: no allocation on a device, no sync.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from .step_stats import device_memory_stats

__all__ = [
    "state_breakdown", "plan_state_memory", "all_devices_memory_stats",
    "oom_risk",
]


# ---------------------------------------------------------------------------
# state byte breakdown
# ---------------------------------------------------------------------------


def _axis_product(entry, axis_sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for a in names:
        n *= int(axis_sizes.get(a, 1))
    return n


def _leaf_bytes(leaf, spec, axis_sizes) -> tuple:
    """(global_bytes, per_device_bytes) for one tensor or array."""
    import numpy as np
    import torch

    shape = tuple(getattr(leaf, "shape", ()))
    itemsize = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                else np.dtype(leaf.dtype).itemsize)
    global_bytes = int(math.prod(shape)) * itemsize
    if spec is not None and axis_sizes:
        entries = list(spec) + [None] * (len(shape) - len(spec))
        per = itemsize
        for dim, e in zip(shape, entries):
            per *= -(-dim // _axis_product(e, axis_sizes))  # ceil div
        return global_bytes, int(per)
    return global_bytes, global_bytes


def state_breakdown(tree, specs=None, axis_sizes: Optional[Dict[str, int]]
                    = None) -> Dict[str, int]:
    """Fold a state tree into ``{global_bytes, per_device_bytes,
    n_leaves}``. ``specs`` (a tree of the same structure whose leaves are
    partition specs: tuples of mesh axis names or None per dim) and
    ``axis_sizes`` ({mesh axis name: size}) make the per-device bytes
    sharded; leaves without them count as replicated."""
    from ..utils.tree import flatten

    leaves = flatten(tree)
    if specs is not None:
        spec_of = dict(flatten(specs))
        missing = [p for p, _ in leaves if p not in spec_of]
        if missing:
            raise ValueError(f"specs do not match the state tree: no spec "
                             f"for {missing[:3]}")
        spec_leaves = [spec_of[p] for p, _ in leaves]
    else:
        spec_leaves = [None] * len(leaves)
    g = d = 0
    for (_, leaf), spec in zip(leaves, spec_leaves):
        gb, db = _leaf_bytes(leaf, spec, axis_sizes or {})
        g += gb
        d += db
    return {"global_bytes": g, "per_device_bytes": d,
            "n_leaves": len(leaves)}


_AXES = ("data", "pipe", "sharding", "expert", "sep", "model")


def plan_state_memory(model_cfg, trainer_cfg=None,
                      axis_sizes: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Any]:
    """Allocation-free state-memory plan of a ``HybridParallelTrainer``
    layout for ``model_cfg`` (GPT or LLaMA, through the trainer's
    ``_arch_for``): the params' shapes as ``meta`` tensors, the
    trainer's param specs (``sanitize_specs``) and moment specs
    (``_opt_specs``) are derived for the axis sizes, and the params plus
    AdamW's two fp32 moments and its int32 step fold to global and
    per-rank bytes, key for key the JAX package's plan."""
    from ..parallel import hybrid

    cfg = trainer_cfg if trainer_cfg is not None else hybrid.TrainerConfig()
    if axis_sizes is None:
        axis_sizes = {"data": cfg.dp, "pipe": cfg.pp,
                      "sharding": cfg.sharding, "expert": 1,
                      "sep": cfg.sep, "model": cfg.mp}
    else:
        axis_sizes = {**{a: 1 for a in _AXES}, **axis_sizes}

    class _AxisSizes:
        # stands in for a Mesh: the spec derivation reads mesh.shape only
        shape = axis_sizes

    _, specs_fn, _, arch = hybrid._arch_for(model_cfg)
    shapes = hybrid.param_shapes(model_cfg)
    pspecs = hybrid.sanitize_specs(
        shapes, specs_fn(model_cfg, cfg.zero_stage, cfg.pp), _AxisSizes)
    ospecs = hybrid._opt_specs(pspecs, cfg.zero_stage, shapes, _AxisSizes)
    params = state_breakdown(shapes, pspecs, axis_sizes)
    one_moment = state_breakdown(shapes, ospecs, axis_sizes)
    opt = {  # AdamW: m + v (fp32, the params' shapes) + the step scalar
        "global_bytes": 2 * one_moment["global_bytes"] + 4,
        "per_device_bytes": 2 * one_moment["per_device_bytes"] + 4,
        "n_leaves": 2 * one_moment["n_leaves"] + 1,
    }
    return {
        "arch": arch,
        "axis_sizes": dict(axis_sizes),
        "params": params,
        "opt_state": opt,
        "total_per_device_bytes": (params["per_device_bytes"]
                                   + opt["per_device_bytes"]),
        "total_global_bytes": (params["global_bytes"]
                               + opt["global_bytes"]),
    }


# ---------------------------------------------------------------------------
# live watermark across devices
# ---------------------------------------------------------------------------

_AGG_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
             "largest_alloc_size")


def all_devices_memory_stats(devices) -> Optional[Dict[str, Any]]:
    """Aggregate :func:`~.step_stats.device_memory_stats` across
    ``devices``: per-key max + sum. Returns None when NO device has
    stats (the CPU), matching its never-fake contract."""
    per_device: List[Dict[str, int]] = []
    for dev in devices:
        stats = device_memory_stats(dev)
        if stats:
            per_device.append(stats)
    if not per_device:
        return None
    agg: Dict[str, Any] = {"n_devices_with_stats": len(per_device),
                           "max": {}, "sum": {}}
    for key in _AGG_KEYS:
        vals = [s[key] for s in per_device if key in s]
        if vals:
            agg["max"][key] = max(vals)
            agg["sum"][key] = sum(vals)
    return agg


# ---------------------------------------------------------------------------
# OOM proximity
# ---------------------------------------------------------------------------


def oom_risk(bytes_in_use: int, temp_bytes: int,
             capacity_bytes: Optional[int],
             fraction: float = 0.9) -> Optional[Dict[str, Any]]:
    """Project the worst step peak — live bytes in use plus the step's
    transient temp bytes — against the card's capacity. Returns
    ``{near_oom, projected_bytes, capacity_bytes, fraction,
    headroom_bytes}``, or None when the capacity is unknown (no table
    entry, no override): a proximity verdict against a guessed ceiling
    would be noise."""
    if not capacity_bytes or capacity_bytes <= 0:
        return None
    projected = int(bytes_in_use) + int(temp_bytes or 0)
    threshold = fraction * capacity_bytes
    return {
        "near_oom": projected >= threshold,
        "projected_bytes": projected,
        "capacity_bytes": int(capacity_bytes),
        "fraction": fraction,
        "headroom_bytes": int(capacity_bytes - projected),
    }
