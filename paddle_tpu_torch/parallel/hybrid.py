"""The trainer for GPT and LLaMA, on one device or over a mesh of ranks
(port of ``paddle_tpu.parallel.hybrid``).

``HybridParallelTrainer.step`` runs one training step: value and grad of
the model family's loss, ``transformer_core.gpt_loss`` or, for a
``LlamaConfig``, ``llama_core.llama_loss`` (``_arch_for``; the packed
flash kernels K-PACK, K-DQ and K-DKV on CUDA; with
``packed_sequences=True``, GPT only as in the JAX package, the segmented
K-SEG, K-SDQ and K-SDKV over rows packed by ``io.packing``), AdamW with
global-norm clipping, and the in-step anomaly guard, which commits the
new params and optimizer state only where the loss and the grad norm
are finite (``where(finite, new, old)``). The guard's counters stay on
the device; the host reads one step's skip flag after the next step has
been enqueued (lag 1), through a pinned copy and a CUDA event, so the
guard adds no other synchronisation.

Dynamic loss scaling (``loss_scaling=True``) lives in the same guard,
on the device: the loss is multiplied by the scale and the grads divided
by it; a skipped step halves the scale (floored at 1.0), and
``scale_incr_every`` finite steps in a row double it.

A checkpoint is the full train state in the JAX package's layout and
key names (``_flat_state``: ``['params'][...]``, ``['opt'][...]``,
``guard/*``, ``meta/global_step``, ``data/cursor_json``), written
atomically by ``distributed.checkpoint`` (``save_checkpoint``, sync or
async) and restored by ``load_checkpoint``; a checkpoint of either
package resumes in the other. Over a mesh every rank saves at the same
step: its shards of the params and the moments as pieces of the global
values (``utils.convert.shard_pieces``: global indexes in the JAX
layout, a piece several ranks hold written by the lowest), the
replicated values from rank 0; loading reassembles the global values of
the newest step every rank completed (the ranks agree on it) and cuts
this trainer's shards of them, on whatever mesh it runs.
``enable_preemption_guard`` turns SIGTERM or SIGUSR1 into a just-in-time
checkpoint and :class:`TrainingPreempted` (exit 118) at the next step
boundary; over a mesh the notice is all-reduced (MAX) at every step
boundary, so every rank writes its shard at the same step and exits (a
rank that stopped while its peers stepped on would deadlock them). A
divergence abort rolls the state back to the newest valid checkpoint
before it raises, on every rank to the same step. The port has no
framework RNG stream yet, so it writes no ``rng/key`` and ignores one it
loads (neither loss draws random numbers).

The cross-rank consistency check (``consistency_check_every`` or
:meth:`enable_consistency_check`) digests the full params, the loss
bits, the loss scale and the data cursor every K steps and all-gathers
the digests (``distributed.consistency``); ranks that disagree raise
``DesyncError`` (exit 119). The ``PADDLE_FI_DESYNC_AT_STEP`` and
``PADDLE_FI_STALL_AT_STEP`` drills run at the same step boundary.

Run telemetry (``telemetry=True``, the default) is the JAX package's:
per-step accounting (:attr:`telemetry`, a ``StepAccounting``: step
time, tokens/s, MFU from the analytic ``6 * params * tokens`` FLOPs,
device memory), JSONL step records when ``$PADDLE_OBS_DIR`` is set,
:meth:`memory_plan`, the OOM-proximity warning, the guard's
``loss_scale`` gauge and skip counter, and with ``http_port`` the ops
endpoint (``/metrics``, ``/healthz``). On the CPU a step's time is the
host wall of its dispatch, as in the JAX package. On CUDA the host's
dispatch wall strays from the device's pace by a few percent (up to
3.4% over 9 steps of GPT-345M at 8 x 1024 on an H100), so a step's time
is read from two CUDA events recorded around its dispatch (device time
from the later of the dispatch and the previous step's end, to its own
end), once its end event has fired: nothing waits for the device on the
step path.

Multi-rank training: with any of ``dp``, ``pp``, ``sharding``, ``mp``
or ``sep`` above 1 the trainer runs on a ``distributed.mesh.Mesh`` (built
from the config over the initialised ``torch.distributed`` world unless
one is passed), one process per rank, each holding its shards of the
JAX package's layout: the param specs of the model family
(``gpt_param_specs`` / ``llama_param_specs``) after
:func:`sanitize_specs`, and the AdamW moments under :func:`_opt_specs`
(ZeRO >= 1 shards each moment over ``"sharding"`` along its largest
dividing dim). A step:

- :meth:`shard_batch` cuts the global host batch: rows over ``("data",
  "sharding")``, the sequence over ``"sep"``, in zigzag order when it
  divides by ``2 * sep`` and ``ring_attention`` is on (then the ring is
  the zigzag ring end to end), else in contiguous shards;
- packed batches (``packed_sequences=True``, with dp, mp and ZeRO 1-3)
  take this rank's rows of the segment ids and of the positions, which
  are derived from the global ids before the cut (:meth:`shard_packed`);
- the family's loss over the rank's shards (tensor parallelism over
  ``"model"``, ring attention over ``"sep"``: the zigzag ring, or with
  ``ring_attention=False`` the naive ring on contiguous shards; ZeRO-3's
  per-layer gathers) is the global batch's mean on every rank (the
  packed mean over the global batch's real labels);
- the grads are summed over ``("data", "sharding", "sep")``: all-reduced
  (ZeRO 1), reduce-scattered over ``"sharding"`` onto the moment's shard
  (ZeRO 2, and ZeRO 3's replicated leaves), or already reduce-scattered
  by the gathers' backward (ZeRO 3's sharded params);
- with ``pp > 1`` the step is a pipeline schedule over ``"pipe"``
  (``parallel.pipeline``; ``micro_batches`` 0 means ``2 * pp``): GPipe
  for ``pp_schedule="gpipe"``, 1F1B, or interleaved 1F1B for ``vpp >
  1``, each returning the loss and this stage's grads; the sequence
  ring runs inside each stage. The JAX package's pipeline leaves
  ``"sep"`` to GSPMD whatever ``ring_attention`` says; the port's ring
  computes the same function by another mechanism. The leaves held by
  every stage (the
  embeddings, the final norm, LLaMA's head) get grads on stage 0 and the
  last only, and are summed over ``"pipe"`` as well. ``vpp > 1`` with
  ``pp == 1`` trains as ``pp == 1``, as in the JAX package;
- :func:`global_norm` over the sharded grads counts each element once;
  AdamW updates the moment's shard, decaying by the FULL leaf's
  ``ndim >= 2``; the guard's finite flag is all-reduced so every rank
  skips the same step; the updated shards are all-gathered over
  ``"sharding"`` back to the param layout.

The telemetry counts the global batch's tokens and the global params,
with ``n_devices`` the world, as the JAX package does (packed batches
too: every token slot of the global batch); with ``http_port`` every
rank serves its own endpoint. Loss scaling with ``pp > 1`` and packed
sequences with ``pp > 1``, with ``sep > 1`` or for LLaMA raise
``ValueError``, as in the JAX package. ``TrainerConfig`` keeps every
field and default of the JAX package's; ``compile_ledger`` is accepted
and records nothing (PyTorch runs eagerly, there is no compile to
ledger).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import sys
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from .. import observability as obs
from ..device import resolve_device
from ..distributed import communication as comm
from ..distributed import consistency as cns
from ..distributed.checkpoint import (AsyncCheckpointManager,
                                      CheckpointError, CheckpointManager,
                                      Sharded, load_state_dict)
from ..distributed.collective_runtime import flight_recorder
from ..distributed.consistency import DESYNC_EXIT_CODE, DesyncError
from ..distributed.mesh import P, build_mesh
from ..io.packing import positions_from_segment_ids
from ..models.llama import LlamaConfig
from ..ops.ring_attention import to_zigzag
from ..utils import fault_injection as fi
from ..utils.convert import (expected_gpt_params, expected_llama_params,
                             from_head_aligned, qkv_col_order, shard_params,
                             shard_pieces)
from ..utils.preemption import (PREEMPTED_EXIT_CODE, PreemptionGuard,
                                TrainingPreempted)
from ..utils.tree import flatten, tree_map, unflatten
from . import llama_core, pipeline
from . import transformer_core as core

__all__ = ["DIVERGENCE_EXIT_CODE", "NumericalDivergenceError",
           "PREEMPTED_EXIT_CODE", "PreemptionGuard", "TrainingPreempted",
           "DESYNC_EXIT_CODE", "DesyncError",
           "TrainerConfig", "HybridParallelTrainer", "global_norm",
           "adamw_init", "adamw_update", "sanitize_specs"]

# exit code for a script that lets NumericalDivergenceError end it (the
# JAX package's elastic watcher classifies it as "divergence")
DIVERGENCE_EXIT_CODE = 117


class NumericalDivergenceError(RuntimeError):
    """Raised once the anomaly guard has skipped
    ``TrainerConfig.max_consecutive_skips`` steps in a row. Where the
    trainer knows a checkpoint root, it first reloads the newest valid
    checkpoint there, and ``rolled_back_to`` is its step (None without a
    root or a valid checkpoint)."""

    exit_code = DIVERGENCE_EXIT_CODE

    def __init__(self, msg, rolled_back_to=None):
        super().__init__(msg)
        self.rolled_back_to = rolled_back_to


@dataclasses.dataclass
class TrainerConfig:
    dp: int = 1
    mp: int = 1          # tensor parallel
    pp: int = 1          # pipeline parallel
    sharding: int = 1    # ZeRO axis size
    sep: int = 1         # sequence/context parallel
    zero_stage: int = 1
    micro_batches: int = 0
    pp_schedule: str = "1f1b"
    vpp: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    compute_dtype: Any = torch.bfloat16
    # False | True/"full" | "dots" | "names:a,b" (transformer_core)
    remat: Any = True
    ring_attention: bool = True
    seed: int = 0
    telemetry: bool = True
    anomaly_guard: bool = True
    # abort threshold of consecutive skipped steps (0 disables the abort)
    max_consecutive_skips: int = 8
    loss_scaling: bool = False
    init_loss_scale: float = 2.0 ** 15
    scale_incr_ratio: float = 2.0
    scale_decr_ratio: float = 0.5
    scale_incr_every: int = 1000
    consistency_check_every: int = 0
    compile_ledger: bool = True
    oom_warn_fraction: float = 0.9
    packed_sequences: bool = False
    http_port: Optional[int] = None
    http_host: str = "127.0.0.1"


def _lr_at(cfg: TrainerConfig, step):
    """Linear warmup + cosine decay at ``step`` (an fp32 tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1),
        0.0, 1.0)
    return cfg.learning_rate * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in flatten(tree)))


def _clip(cfg: TrainerConfig, gnorm):
    return (torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
            if cfg.grad_clip else 1.0)


def adamw_init(params):
    leaf = flatten(params)[0][1]
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(cfg: TrainerConfig, params, grads, opt):
    """AdamW with global-norm clipping, the schedule read at
    ``opt["step"] + 1``. Decoupled weight decay applies to every leaf
    with ``ndim >= 2`` -- in the stacked layout that includes the
    per-layer LayerNorm gains and biases and the block biases, ``(L, h)``,
    but not ``lnf_g``/``lnf_b`` -- exactly as the JAX package does.
    Returns ``(new_params, new_opt, grad_norm)``."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    clip = _clip(cfg, gnorm)
    lr, bc1, bc2 = _schedule(cfg, step)

    def upd(p, g, m, v):
        return _adam_leaf(cfg, p, g, m, v, clip, lr, bc1, bc2, p.dim() >= 2)

    paths = [path for path, _ in flatten(params)]
    out = [upd(*leaves) for leaves in zip(*(
        [x for _, x in flatten(t)] for t in (params, grads, opt["m"],
                                             opt["v"])))]
    new_p, new_m, new_v = (unflatten(zip(paths, col)) for col in zip(*out))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm


def _schedule(cfg: TrainerConfig, step):
    """``(lr, bc1, bc2)`` at the int32 ``step`` tensor."""
    stepf = step.float()
    return (_lr_at(cfg, stepf), 1.0 - torch.pow(cfg.beta1, stepf),
            1.0 - torch.pow(cfg.beta2, stepf))


def _adam_leaf(cfg, p, g, m, v, clip, lr, bc1, bc2, decay):
    """One leaf's AdamW update (``decay``: the full leaf has
    ``ndim >= 2``). Returns ``(p, m, v)``."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * clip
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / bc1
    vhat = v / bc2
    step_v = mhat / (torch.sqrt(vhat) + cfg.eps)
    if decay:
        step_v = step_v + cfg.weight_decay * p.float()
    return (p.float() - lr * step_v).to(p.dtype), m, v


def _guard_defaults(cfg: TrainerConfig) -> dict:
    """Fresh anomaly-guard state (kept on the device by the trainer)."""
    return {
        "loss_scale": np.float32(
            cfg.init_loss_scale if cfg.loss_scaling else 1.0),
        "good_steps": np.int32(0),
        "skip_count": np.int32(0),
        "skips_total": np.int32(0),
    }


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def sanitize_specs(params, specs, mesh):
    """Drop the entries whose axis size does not divide the dim (the
    JAX package's shape guard). ``params``: a tree of shaped leaves;
    ``mesh``: anything with ``shape`` ``{axis: size}``."""
    spec_of = dict(flatten(specs))
    out = []
    for path, leaf in flatten(params):
        entries = list(spec_of[path])
        entries += [None] * (len(leaf.shape) - len(entries))
        out.append((path, P(*(e if d % _axis_size(mesh, e) == 0 else None
                              for d, e in zip(leaf.shape, entries)))))
    return unflatten(out)


def _has_sharding(entries) -> bool:
    return any("sharding" in (e if isinstance(e, (tuple, list)) else (e,))
               for e in entries if e is not None)


def _opt_specs(param_specs, zero_stage: int, shapes, mesh):
    """The moments' specs: ZeRO >= 1 shards m/v over ``"sharding"``
    along each leaf's largest dividing unsharded dim (the first such
    on a tie), unless the param is already sharded there."""
    nshard = mesh.shape["sharding"]
    spec_of = dict(flatten(param_specs))
    out = []
    for path, leaf in flatten(shapes):
        shape = tuple(leaf.shape)
        entries = list(spec_of[path]) + [None] * (
            len(shape) - len(spec_of[path]))
        if zero_stage >= 1 and not _has_sharding(entries):
            best, best_dim = -1, -1
            for i, (d, e) in enumerate(zip(shape, entries)):
                if e is None and d % nshard == 0 and d > best:
                    best, best_dim = d, i
            if best_dim >= 0:
                entries[best_dim] = "sharding"
        out.append((path, P(*entries)))
    return unflatten(out)


def _arch_for(model_cfg):
    """The functional core for a model config's family: ``(init, specs,
    loss, name)``, GPT by default, LLaMA for a ``LlamaConfig``."""
    if isinstance(model_cfg, LlamaConfig):
        return (llama_core.llama_init, llama_core.llama_param_specs,
                llama_core.llama_loss, "llama")
    return core.gpt_init, core.gpt_param_specs, core.gpt_loss, "gpt"


def param_shapes(model_cfg):
    """The family's param tree as ``meta`` tensors of its shapes. No init
    runs: under a ``torch.device("meta")`` context the first init of a
    process imports PyTorch's compiler stack (~800 modules; 7 s a rank on
    the H100's host)."""
    expected = (expected_llama_params if isinstance(model_cfg, LlamaConfig)
                else expected_gpt_params)(model_cfg)
    return tree_map(lambda shape: torch.empty(shape, device="meta"),
                    expected)


_LOSS_AXES = ("data", "sharding", "sep")


class _Layout:
    """The trainer's state layout over a mesh: the sanitized param specs,
    the moments' specs, and per leaf (by path) the full shape, whether
    the param itself is sharded over ``"sharding"`` (ZeRO 3), the dim
    its moments add ``"sharding"`` on (``opt_dim``, None if none), and
    how many ranks hold each element of the moments' shard (``rep``,
    for the global norm) and whether every pipeline stage holds the leaf
    (``pipe_rep``: its grads are summed over ``"pipe"``)."""

    def __init__(self, model_cfg, cfg, mesh, specs_fn):
        self.shapes = param_shapes(model_cfg)
        self.pspecs = sanitize_specs(
            self.shapes, specs_fn(model_cfg, cfg.zero_stage, cfg.pp), mesh)
        self.ospecs = _opt_specs(self.pspecs, cfg.zero_stage, self.shapes,
                                 mesh)
        self.leaf = {}
        pspec_of = dict(flatten(self.pspecs))
        shape_of = dict(flatten(self.shapes))
        for path, ospec in flatten(self.ospecs):
            shape = tuple(shape_of[path].shape)
            pspec = pspec_of[path]
            zero3 = _has_sharding(pspec)
            opt_dim = None
            if not zero3 and mesh.shape["sharding"] > 1:
                opt_dim = next((i for i, e in enumerate(ospec)
                                if e == "sharding"), None)
            held = math.prod(_axis_size(mesh, e) for e in ospec)
            on_pipe = any("pipe" in (e if isinstance(e, (tuple, list))
                                     else (e,)) for e in pspec)
            self.leaf[path] = {"shape": shape, "zero3": zero3,
                               "opt_dim": opt_dim, "ndim": len(shape),
                               "rep": mesh.world // held,
                               "pipe_rep": (mesh.shape["pipe"] > 1
                                            and not on_pipe)}


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['opt']['m']['wte']``."""
    return "".join(f"[{k!r}]" for k in path)


class HybridParallelTrainer:
    """GPT or LLaMA trainer on ``device`` (CUDA unless ``"cpu"`` is asked
    for), over a mesh of ranks when the config asks for one.

    Usage:
        t = HybridParallelTrainer(gpt_345m(), TrainerConfig())
        loss = t.step(tokens, labels)

    Multi-rank: every rank of an initialised ``torch.distributed`` world
    (backend ``"nccl"`` with a card per rank, or ``"gloo"``) builds the
    trainer with the same config and steps on the same global batch;
    ``mesh`` is built from the config unless given, on ``device``.
    ``params`` (the full stacked params, the JAX package's layout) start
    the trainer in place of the seed's init.
    """

    def __init__(self, model_cfg, cfg: TrainerConfig, device=None,
                 mesh=None, params=None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        (self._init_fn, self._specs_fn, self._loss_fn,
         self.arch) = _arch_for(model_cfg)
        self._validate()
        axes = {a: getattr(cfg, a) for a in ("dp", "pp", "sharding", "mp",
                                             "sep")}
        self.mesh = self._layout = None
        if mesh is not None or any(n != 1 for n in axes.values()):
            self.mesh = mesh if mesh is not None else build_mesh(
                dp=cfg.dp, pp=cfg.pp, sharding=cfg.sharding, mp=cfg.mp,
                sep=cfg.sep, device=device)
            self._validate_mesh()
            self.device = self.mesh.device
            self._layout = _Layout(model_cfg, cfg, self.mesh, self._specs_fn)
        else:
            self.device = resolve_device(device)
        if params is None:
            params = self._init_fn(model_cfg,
                                   torch.Generator().manual_seed(cfg.seed))
        self.set_full_params(params)
        self.opt = self._fresh_opt()
        self.guard = {k: torch.tensor(v, device=self.device)
                      for k, v in _guard_defaults(cfg).items()}
        self.global_step = 0          # data-consumption steps dispatched
        self._pending_guard = None    # (step, host flags, CUDA event)
        self.last_grad_norm = None    # the last step's global grad norm
        self.anomaly = {"skips_total": 0, "consecutive": 0,
                        "last_skipped": False,
                        "loss_scale": float(self.guard["loss_scale"])}
        self._ckpt_root = None        # newest root seen by save/load
        self._async_mgrs = {}         # root -> AsyncCheckpointManager
        self._preempt_guard = None    # PreemptionGuard when enabled
        self._preempt_ckpt = None     # (root, dataloader, keep_last_n)
        self._consistency = None      # ConsistencyChecker when enabled
        self._consistency_dl = None   # dataloader whose cursor is digested
        if cfg.consistency_check_every:
            self.enable_consistency_check(cfg.consistency_check_every)
        # the flight recorder now: its thread starts when a flight dir or
        # a watchdog timeout is set, so a rank wedged before its first
        # collective still answers its peers' dump requests
        flight_recorder()
        # -- run telemetry (built lazily on the first recorded step) -------
        self._accounting = None
        self._flops_published = False
        self._timings = deque()       # CUDA steps whose time is unread
        # -- memory observability ------------------------------------------
        self._exec_plan = None        # the measured step's memory plan
        self._measure_next = False    # memory_plan(compute_executable=True)
        self._mem_devices = None      # None = unprobed; [] = no stats
        self._hbm_cap = -1            # -1 = unresolved; 0 = unknown
        self._oom_latched = False
        # -- live ops endpoint (opt-in: cfg.http_port) ---------------------
        self.http = None
        if cfg.http_port is not None:
            self.http = obs.ObsHTTPEndpoint(
                port=cfg.http_port, host=cfg.http_host,
                health=self._health_snapshot).start()

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world

    def _validate_mesh(self):
        cfg, mesh, mcfg = self.cfg, self.mesh, self.model_cfg
        want = {"data": cfg.dp, "pipe": cfg.pp, "sharding": cfg.sharding,
                "sep": cfg.sep, "model": cfg.mp, "expert": 1}
        if mesh.shape != {a: want[a] for a in mesh.shape}:
            raise ValueError(f"mesh {mesh.shape} does not match the "
                             f"config's axes {want}")
        mp = cfg.mp
        heads = {"num_heads": mcfg.num_heads}
        if self.arch == "llama":
            heads["kv heads"] = mcfg.kv_heads
        for what, n in {**heads, "ffn_size": mcfg.ffn_size}.items():
            if n % mp:
                raise ValueError(f"tensor parallelism needs {what} ({n}) "
                                 f"divisible by mp ({mp})")

    def _validate(self):
        cfg = self.cfg
        if cfg.pp_schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown pp_schedule: {cfg.pp_schedule!r}")
        if cfg.vpp < 1:
            raise ValueError(f"vpp must be >= 1, got {cfg.vpp}")
        if cfg.vpp > 1 and cfg.pp_schedule != "1f1b":
            raise ValueError(
                "virtual pipeline stages (vpp > 1) require "
                "pp_schedule='1f1b': the GPipe schedule has no interleaved "
                "variant")
        if cfg.loss_scaling and cfg.pp > 1:
            raise ValueError(
                "loss_scaling is not supported with pipeline parallelism "
                "(pp > 1): the schedules compute grads per stage, outside "
                "the scaled-loss wrapper")
        if cfg.loss_scaling and not cfg.anomaly_guard:
            raise ValueError(
                "loss_scaling=True requires anomaly_guard=True: the guard "
                "branch IS the scaler")
        if cfg.packed_sequences and cfg.pp > 1:
            raise ValueError(
                "packed_sequences is not supported with pipeline "
                "parallelism (pp > 1): the schedules compute per-stage "
                "losses outside the segment-aware loss")
        if cfg.packed_sequences and cfg.sep > 1:
            raise ValueError(
                "packed_sequences cannot combine with sequence parallelism "
                "(sep > 1): the ring shards the sequence while the packed "
                "mask is per-token; run packed batches with sep=1")
        if cfg.packed_sequences and self.arch != "gpt":
            raise ValueError(
                f"packed_sequences supports the GPT family only (got arch "
                f"{self.arch!r}): per-segment RoPE reset is not wired "
                "through the LLaMA core yet")
        core._remat_wrap(None, cfg.remat)   # an unknown policy raises now

    # -- the step -----------------------------------------------------------
    def loss_and_grads(self, params, tokens, labels, poison=1.0, extras=(),
                       scale=None):
        """``(loss * poison, grads)`` of the family's loss at ``params``:
        the loss detached, the grads a tree like ``params``. ``extras`` is
        ``(segment_ids, positions)`` in packed mode (GPT), else empty.
        With a loss ``scale`` (an fp32 device scalar) the grads are taken
        of ``loss * scale`` and multiplied by ``1 / scale``. With
        ``pp > 1`` the loss and grads come from the pipeline schedule."""
        if self.cfg.pp > 1:
            loss, grads = self._pipeline_grads(params, tokens, labels)
            return loss * poison, tree_map(lambda g: g * poison, grads)
        paths, leaves = zip(*((path, p.detach().requires_grad_(True))
                              for path, p in flatten(params)))
        kw = dict(zip(("segment_ids", "positions"), extras))
        if self.mesh is not None:
            kw.update(mesh=self.mesh, specs=self._layout.pspecs,
                      ring=self._ring_for(tokens))
        raw = self._loss_fn(self.model_cfg, unflatten(zip(paths, leaves)),
                            tokens, labels,
                            compute_dtype=self.cfg.compute_dtype,
                            remat=self.cfg.remat, **kw) * poison
        if scale is None:
            grads = torch.autograd.grad(raw, leaves)
        else:
            grads = torch.autograd.grad(raw * scale.to(raw.dtype), leaves)
            inv = 1.0 / scale
            grads = [g * inv.to(g.dtype) for g in grads]
        return raw.detach(), unflatten(zip(paths, grads))

    def _pipeline_grads(self, params, tokens, labels):
        """``(loss, grads)`` of the schedule the config names: GPipe,
        1F1B, or interleaved 1F1B (``vpp > 1``)."""
        cfg = self.cfg
        kw = dict(compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                  mesh=self.mesh, ring=self._ring_for(tokens),
                  specs=self._layout.pspecs)
        args = (self.model_cfg, params, tokens, labels, cfg.pp)
        m = cfg.micro_batches or 2 * cfg.pp
        if cfg.vpp > 1:
            return pipeline.pipeline_interleaved_grads(*args, cfg.vpp, m,
                                                       **kw)
        if cfg.pp_schedule == "gpipe":
            return pipeline.pipeline_gpipe_grads(*args, m, **kw)
        return pipeline.pipeline_1f1b_grads(*args, m, **kw)

    def _ring_for(self, tokens):
        """The ring spec of a local batch: None at sep 1; the end-to-end
        zigzag ring when ``ring_attention`` is on and the global length
        divides by ``2 * sep`` (the local one is then even:
        :meth:`shard_batch` permuted it), else the naive ring on
        contiguous shards (the JAX package's GSPMD sequence sharding
        without ``ring_attention`` computes the same function)."""
        n = self.mesh.shape["sep"]
        if n == 1:
            return None
        if self.cfg.ring_attention and tokens.shape[-1] % 2 == 0:
            return (self.mesh, "sep", "zigzag")
        return (self.mesh, "sep")

    def _sharded_update(self, params, grads, opt):
        """The multi-rank AdamW: grads summed over the loss axes onto the
        moments' shards (and over ``"pipe"`` for the leaves every stage
        holds), the global norm, the update of each shard.
        Returns ``(new_p, new_opt, gnorm, old_p)``: the params before and
        after, and the moments, in the moments' shard layout
        (``_unshard_opt_dim`` brings the params back)."""
        cfg, mesh = self.cfg, self.mesh
        sh = mesh.group("sharding")
        paths = [path for path, _ in flatten(params)]
        g_of = dict(flatten(grads))
        p_sl, g_sl = {}, {}
        for path, p in flatten(params):
            info = self._layout.leaf[path]
            g, dim = g_of[path], info["opt_dim"]
            if info["pipe_rep"]:         # stage 0's and the last's parts
                self._sum(g, ("pipe",))
            if info["zero3"]:            # reduce-scattered by the gather
                self._sum(g, ("data", "sep"))
            elif dim is not None and cfg.zero_stage >= 2:
                g = comm.scatter_dim(g, dim, sh)
                self._sum(g, ("data", "sep"))
            else:
                self._sum(g, _LOSS_AXES)
                if dim is not None:
                    g = self._my_slice(g, dim)
            g_sl[path] = g
            p_sl[path] = self._my_slice(p, dim) if dim is not None else p
        sq = sum(torch.sum(torch.square(g_sl[path].float()))
                 / self._layout.leaf[path]["rep"] for path in paths)
        self._sum(sq, mesh.axis_names)
        gnorm = torch.sqrt(sq)
        step = opt["step"] + 1
        clip = _clip(cfg, gnorm)
        lr, bc1, bc2 = _schedule(cfg, step)
        m_of, v_of = dict(flatten(opt["m"])), dict(flatten(opt["v"]))
        out = [_adam_leaf(cfg, p_sl[path], g_sl[path], m_of[path],
                          v_of[path], clip, lr, bc1, bc2,
                          self._layout.leaf[path]["ndim"] >= 2)
               for path in paths]
        new_p, new_m, new_v = (unflatten(zip(paths, col))
                               for col in zip(*out))
        return (new_p, {"m": new_m, "v": new_v, "step": step}, gnorm,
                unflatten(p_sl.items()))

    def _sum(self, t, axes):
        """All-reduce (sum) ``t`` in place over the mesh ``axes``."""
        g = (self.mesh.world_group if tuple(axes) == self.mesh.axis_names
             else self.mesh.group(axes))
        if g is not None:
            comm.all_reduce(t, group=g)

    def _my_slice(self, t, dim):
        n, i = self.mesh.shape["sharding"], self.mesh.coords["sharding"]
        w = t.shape[dim] // n
        return t.narrow(dim, i * w, w)

    def _unshard_opt_dim(self, new_p):
        """The updated moment-layout shards gathered over ``"sharding"``
        back into the param layout."""
        sh = self.mesh.group("sharding")
        return unflatten(
            (path, p if self._layout.leaf[path]["opt_dim"] is None else
             comm.all_gather_dim(p, self._layout.leaf[path]["opt_dim"], sh))
            for path, p in flatten(new_p))

    def _step_fn(self, tokens, labels, extras, poison):
        """value-and-grad, AdamW, and the guard's select; returns
        ``(params, opt, guard, loss, grad_norm, skipped)``, all on the
        device."""
        cfg, params, opt, guard = self.cfg, self.params, self.opt, self.guard
        scale = guard["loss_scale"]
        loss, grads = self.loss_and_grads(
            params, tokens, labels, poison, extras,
            scale if cfg.loss_scaling else None)
        if self.mesh is None:
            new_p, new_opt, gnorm = adamw_update(cfg, params, grads, opt)
            old_p = params
        else:
            new_p, new_opt, gnorm, old_p = self._sharded_update(
                params, grads, opt)
        del grads   # one state's worth of memory less at the commit below
        if not cfg.anomaly_guard:
            if self.mesh is not None:
                new_p = self._unshard_opt_dim(new_p)
            return (new_p, new_opt, guard, loss, gnorm,
                    torch.zeros((), dtype=torch.bool, device=loss.device))
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        if self.mesh is not None:
            # every rank skips the same step
            bad = (~finite).float()
            comm.all_reduce(bad, comm.ReduceOp.MAX,
                            group=self.mesh.world_group)
            finite = bad == 0

        def commit(new, old):
            return tree_map(lambda n, o: torch.where(finite, n, o), new, old)

        new_p = commit(new_p, old_p)
        new_opt = commit(new_opt, opt)
        if self.mesh is not None:
            new_p = self._unshard_opt_dim(new_p)
        skipped = ~finite
        new_guard = {
            "skip_count": torch.where(finite, 0, guard["skip_count"] + 1
                                      ).to(torch.int32),
            "skips_total": (guard["skips_total"]
                            + skipped.to(torch.int32)),
        }
        if cfg.loss_scaling:
            good = torch.where(finite, guard["good_steps"] + 1, 0)
            grow = finite & (good >= cfg.scale_incr_every)
            new_guard["loss_scale"] = torch.where(
                finite,
                torch.where(grow, scale * cfg.scale_incr_ratio, scale),
                torch.clamp(scale * cfg.scale_decr_ratio, min=1.0),
            ).to(torch.float32)
            new_guard["good_steps"] = torch.where(grow, 0, good).to(
                torch.int32)
        else:
            new_guard["loss_scale"] = scale
            new_guard["good_steps"] = torch.where(
                finite, guard["good_steps"] + 1, 0).to(torch.int32)
        return new_p, new_opt, new_guard, loss, gnorm, skipped

    # -- state over a mesh ---------------------------------------------------
    def _fresh_opt(self):
        """Zero moments (in the moments' shard layout over a mesh) and
        step 0."""
        if self.mesh is None:
            return adamw_init(self.params)
        n = self.mesh.shape["sharding"]

        def zeros(path, p):
            dim = self._layout.leaf[path]["opt_dim"]
            shape = list(p.shape)
            if dim is not None:
                shape[dim] //= n
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        m = unflatten((path, zeros(path, p)) for path, p in
                      flatten(self.params))
        return {"m": m, "v": tree_map(torch.zeros_like, m),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def set_full_params(self, params) -> None:
        """Take the FULL stacked params (the JAX package's layout and
        names; tensors or numpy arrays) as this trainer's: over a mesh,
        this rank's shards of them (``utils.convert.shard_params``). The
        optimizer state is left as it is."""
        if self.mesh is None:
            self.params = tree_map(lambda t: torch.as_tensor(t).to(
                self.device), params)
            return
        shards = shard_params(params, self.model_cfg, self._layout.pspecs,
                              self.mesh.shape, self.mesh.rank)
        self.params = tree_map(lambda t: t.to(self.device), shards)

    def full_params(self):
        """The FULL params as CPU tensors in the JAX package's layout:
        over a mesh every rank's shards all-gathered (every rank must
        call it)."""
        if self.mesh is None:
            return tree_map(lambda t: t.detach().cpu(), self.params)
        return self._gather_full(self.params, self._layout.pspecs)

    def _gather_full(self, tree, specs):
        """``tree`` (the params, or a moment under ``_layout.ospecs``) as
        its FULL CPU values in the JAX layout: every rank's shards
        all-gathered (every rank must call it)."""
        spec_of = dict(flatten(specs))
        out = []
        for path, p in flatten(tree):
            for dim, e in enumerate(spec_of[path]):
                if e is not None:
                    p = comm.all_gather_dim(p, dim, self.mesh.group(e))
            out.append((path, p.detach().cpu()))
        return from_head_aligned(unflatten(out), self.model_cfg,
                                 self.mesh.shape["model"])

    # -- API ----------------------------------------------------------------
    def shard_batch(self, tokens, labels):
        """Host batches -> int64 tensors on the trainer's device: over a
        mesh, this rank's rows (over ``("data", "sharding")``) and
        sequence shard (over ``"sep"``) of the global batch, the
        sequence first permuted into the zigzag order where its length
        divides by ``2 * sep`` and ``ring_attention`` is on (the
        end-to-end zigzag ring)."""
        return self._put(tokens, torch.long), self._put(labels, torch.long)

    def shard_packed(self, segment_ids, positions=None):
        """Packed-mode host ids -> int32 tensors on the trainer's device,
        cut as :meth:`shard_batch` cuts tokens: ``(segment_ids,
        positions)``, the positions derived from the GLOBAL ids when
        missing (before the cut, as the JAX package derives them)."""
        seg = np.asarray(segment_ids, np.int32)
        if positions is None:
            positions = positions_from_segment_ids(seg)
        return self._put(seg, torch.int32), self._put(positions, torch.int32)

    def _put(self, x, dtype):
        """A host array as ``dtype`` on the device: over a mesh, this
        rank's slice of it (:meth:`_local_slice`)."""
        x = np.asarray(x)
        if self.mesh is not None:
            x = self._local_slice(x)
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _local_slice(self, x):
        mesh = self.mesh
        b, s = x.shape
        nb, n = mesh.size(core.BATCH), mesh.shape["sep"]
        if b % nb or s % n:
            raise ValueError(f"batch {x.shape} does not divide over the "
                             f"mesh: {nb} batch shards, {n} sequence shards")
        if n > 1 and self.cfg.ring_attention and s % (2 * n) == 0:
            x = to_zigzag(x, n, axis=1)
        bi, si = mesh.coord(core.BATCH), mesh.coords["sep"]
        return np.ascontiguousarray(
            x[bi * (b // nb):(bi + 1) * (b // nb),
              si * (s // n):(si + 1) * (s // n)])

    def _packed_extras(self, segment_ids, positions):
        """Validate the packed-mode extras and put them on the device as
        int32 (:meth:`shard_packed`): ``()`` in plain mode,
        ``(segment_ids, positions)`` in packed mode, with positions
        derived from the ids when missing. Raises where the call
        disagrees with ``cfg.packed_sequences`` (silently ignoring ids
        would train across documents)."""
        if not self.cfg.packed_sequences:
            self._no_packed_extras("step()", segment_ids, positions)
            return ()
        if segment_ids is None:
            raise ValueError(
                "packed_sequences=True: step() needs segment_ids (and "
                "positions) -- produce batches with io.packing")
        return self.shard_packed(segment_ids, positions)

    def step(self, tokens, labels, segment_ids=None, positions=None):
        t0 = self._step_begin()
        extras = self._packed_extras(segment_ids, positions)
        t, l = self.shard_batch(tokens, labels)
        loss = self._dispatch_step(t, l, extras)
        if t0 is not None:
            self._step_end(t0, t)
        return loss

    def step_presharded(self, tokens_dev, labels_dev, segment_ids_dev=None,
                        positions_dev=None):
        """One train step over batches already on the device (the tight
        loop of a benchmark), this rank's shards as :meth:`shard_batch`
        gives them; returns the loss as a device tensor. Packed mode
        takes this rank's device-resident segment ids and positions too,
        as :meth:`shard_packed` gives them."""
        t0 = self._step_begin()
        if self.cfg.packed_sequences:
            if segment_ids_dev is None or positions_dev is None:
                raise ValueError(
                    "packed_sequences=True: step_presharded() needs "
                    "device-resident segment_ids and positions")
            extras = (segment_ids_dev, positions_dev)
            for name, x in zip(("segment_ids", "positions"), extras):
                if tuple(x.shape) != tuple(tokens_dev.shape):
                    raise ValueError(
                        f"step_presharded(): {name} of shape "
                        f"{tuple(x.shape)} against tokens of shape "
                        f"{tuple(tokens_dev.shape)}: pass this rank's "
                        "shards (shard_packed)")
        else:
            self._no_packed_extras("step_presharded()", segment_ids_dev,
                                   positions_dev)
            extras = ()
        loss = self._dispatch_step(tokens_dev, labels_dev, extras)
        if t0 is not None:
            self._step_end(t0, tokens_dev)
        return loss

    def _no_packed_extras(self, what, segment_ids, positions):
        if segment_ids is not None or positions is not None:
            raise ValueError(
                f"{what} got segment_ids/positions but "
                "TrainerConfig.packed_sequences is False -- the ids would "
                "be silently ignored; build the trainer with "
                "packed_sequences=True")

    def _dispatch_step(self, t, l, extras=()):
        self.global_step += 1
        measure = self._measure_next
        if measure:
            arg_bytes = self._measure_begin()
        (self.params, self.opt, self.guard, loss, gnorm, skipped) = (
            self._step_fn(t, l, extras, self._poison_for(self.global_step)))
        if measure:
            self._measure_end(arg_bytes)
        self.last_grad_norm = gnorm
        if self.cfg.anomaly_guard:
            prev = self._pending_guard
            # the new step is enqueued before the previous one's flag is
            # read, so the read waits for that step only
            self._pending_guard = (self.global_step,
                                   *self._guard_snapshot(skipped))
            if prev is not None:
                self._resolve_guard(prev)
        # preemption is consumed at the END of the step boundary: after
        # step N is dispatched, before the caller pulls batch N+1, so the
        # just-in-time checkpoint's data cursor is the last trained step's
        if self._preempt_guard is not None and self._preempt_noticed():
            self._handle_preemption(loss)
        self._cross_rank_hooks(loss)
        return loss

    def _preempt_noticed(self) -> bool:
        """This step boundary's preemption notice; over a mesh the MAX of
        every rank's, so all of them stop at the same step."""
        noticed = self._preempt_guard.preemption_noticed(self.global_step)
        if self.world == 1:
            return noticed
        flag = torch.tensor([float(noticed)], device=self.device)
        comm.all_reduce(flag, comm.ReduceOp.MAX, group=self.mesh.world_group)
        return bool(flag.item())

    def _cross_rank_hooks(self, loss) -> None:
        """End-of-step cross-rank work: the desync and stall drills, then
        the periodic consistency check."""
        if fi.armed("desync_at_step") and fi.desync_at_step(self.global_step):
            self._inject_desync()
        if fi.armed("stall_at_step"):
            secs = fi.stall_at_step(self.global_step)
            if secs > 0:
                time.sleep(secs)
        if self._consistency is not None:
            self._consistency.maybe_check(
                self.global_step, lambda: self._consistency_digest(loss))

    def _inject_desync(self) -> None:
        """Drill only: add 1.0 to the first element of this rank's local
        copy of the first param leaf, so its next digest disagrees."""
        items = flatten(self.params)
        path, leaf = items[0]
        bad = leaf.detach().clone()
        flat = bad.view(-1)
        flat[0] = (flat[0].float() + 1.0).to(bad.dtype)
        self.params = unflatten([(path, bad)] + items[1:])

    def enable_consistency_check(self, every: int, dataloader=None,
                                 exchange_dir=None, timeout_s=None):
        """Arm the periodic cross-rank consistency check: every ``every``
        steps all ranks all-gather a digest of their replicated state
        (the global step, a 64-bit hash of the full params, the loss
        bits, the loss scale and, given ``dataloader``, its cursor) and
        diff it; a mismatch raises :class:`DesyncError` (exit
        :data:`DESYNC_EXIT_CODE`, which the launcher restarts in full).
        The exchange directory defaults to ``PADDLE_CONSISTENCY_DIR``
        (the launcher sets it); one rank falls back to a private temp
        dir. Returns the checker."""
        d = exchange_dir or cns.default_exchange_dir()
        if d is None:
            if self.world > 1:
                raise ValueError(
                    "consistency check needs a shared exchange dir: "
                    "launch with paddle_tpu_torch.distributed.launch "
                    "(which sets PADDLE_CONSISTENCY_DIR) or pass "
                    "exchange_dir=")
            import tempfile

            d = tempfile.mkdtemp(prefix="paddle_consistency_")
        ranks = ({} if self.mesh is None else
                 {"rank": self.mesh.rank, "world": self.world})
        self._consistency = cns.ConsistencyChecker(
            every=every, exchange=cns.DigestExchange(d, **ranks),
            timeout_s=timeout_s)
        self._consistency_dl = dataloader
        return self._consistency

    def _consistency_digest(self, loss) -> dict:
        """This rank's view of the replicated state as scalars: one host
        sync (the full params, all-gathered over a mesh) per K steps."""
        dl = self._consistency_dl
        return {
            "step": int(self.global_step),
            "params_hash": cns.tree_digest64(self.full_params()),
            "loss_bits": cns.float_bits(loss),
            "loss_scale": cns.float_bits(self.guard["loss_scale"]),
            "data_cursor": (cns.json_digest64(dl.state_dict())
                            if dl is not None else None),
        }

    def _guard_snapshot(self, skipped):
        """(host flags, event): skipped, skip_count and loss_scale copied
        to pinned host memory behind this step's work."""
        vals = torch.stack([skipped.float(),
                            self.guard["skip_count"].float(),
                            self.guard["loss_scale"].float()])
        if self.device.type != "cuda":
            return vals, None
        host = torch.empty(3, dtype=torch.float32, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _poison_for(self, step) -> float:
        """Loss multiplier: NaN when ``PADDLE_FI_NAN_AT_STEP`` names this
        step (and the guard is on), else exactly 1.0."""
        if self.cfg.anomaly_guard and fi.nan_at_step(step):
            return float("nan")
        return 1.0

    def _resolve_guard(self, pending) -> None:
        """Fold one step's guard flags into the host mirror and enforce
        the divergence budget."""
        step, host, ev = pending
        if ev is not None:
            ev.synchronize()
        skipped, consec, scale = host.tolist()
        skipped = bool(skipped)
        self.anomaly["last_skipped"] = skipped
        self.anomaly["loss_scale"] = float(scale)
        if not skipped:
            self.anomaly["consecutive"] = 0
            if self.cfg.telemetry:
                obs.gauge("loss_scale").set(self.anomaly["loss_scale"])
            return
        consec = int(consec)
        self.anomaly["skips_total"] += 1
        self.anomaly["consecutive"] = consec
        if self.cfg.telemetry:
            obs.counter("train_steps_skipped_total").inc()
            obs.gauge("loss_scale").set(self.anomaly["loss_scale"])
            if obs.enabled():
                obs.emit({"kind": "event", "name": "anomaly_skip",
                          "step": int(step), "consecutive": consec,
                          "loss_scale": self.anomaly["loss_scale"]})
        budget = self.cfg.max_consecutive_skips
        if budget and consec >= budget:
            rolled = None
            if self._ckpt_root is not None:
                rolled = self.load_checkpoint(self._ckpt_root)
            raise NumericalDivergenceError(
                f"{consec} consecutive non-finite train steps (budget "
                f"{budget}) at step {step}: training state is diverging"
                + (f"; rolled back to checkpoint step {rolled}"
                   if rolled is not None else
                   "; no checkpoint root known, state NOT rolled back"),
                rolled_back_to=rolled)

    def grad_scaler_state_dict(self) -> dict:
        """A GradScaler-style ``state_dict()`` of the device-side dynamic
        loss scale (the JAX package's ``paddle_tpu.amp.GradScaler``
        format)."""
        return {"scale": float(self.guard["loss_scale"]),
                "incr_ratio": self.cfg.scale_incr_ratio,
                "decr_ratio": self.cfg.scale_decr_ratio,
                "incr_count": int(self.guard["good_steps"]),
                "decr_count": 0}

    def load_grad_scaler_state_dict(self, sd: dict) -> None:
        """Adopt a GradScaler-style ``state_dict()`` into the device-side
        scaler (the scale and the growth counter)."""
        self.guard["loss_scale"] = torch.tensor(
            np.float32(sd["scale"]), device=self.device)
        self.guard["good_steps"] = torch.tensor(
            np.int32(sd.get("incr_count", 0)), device=self.device)
        self.anomaly["loss_scale"] = float(np.float32(sd["scale"]))

    def anomaly_state(self) -> dict:
        """Resolve any in-flight step and return the host mirror of the
        guard: ``{skips_total, consecutive, last_skipped, loss_scale}``.
        May raise :class:`NumericalDivergenceError`."""
        pending, self._pending_guard = self._pending_guard, None
        if pending is not None:
            self._resolve_guard(pending)
        return dict(self.anomaly)

    def num_params(self) -> int:
        """The model's parameter count (the full leaves' over a mesh)."""
        if self.mesh is not None:
            return int(sum(math.prod(info["shape"])
                           for info in self._layout.leaf.values()))
        return int(sum(p.numel() for _, p in flatten(self.params)))

    # -- fault-tolerant checkpointing --------------------------------------
    # A checkpoint is the FULL train state: params, optimizer, the
    # guard's loss scale and counters, the global step and (given a
    # dataloader) its cursor, so a resumed run continues bit for bit.
    # Keys and layout are the JAX package's, so either package resumes the
    # other's checkpoints.

    def _leaf_layout(self, path):
        """``(full shape, spec)`` of a state leaf over the mesh: a param
        under its spec, a moment under the moments' spec, the step
        replicated."""
        if path == ("opt", "step"):
            return (), P()
        if path[0] == "params":
            ppath, specs = path[1:], self._layout.pspecs
        else:
            ppath, specs = path[2:], self._layout.ospecs
        spec = dict(flatten(specs))[ppath]
        return self._layout.leaf[ppath]["shape"], spec

    def _sharded(self, path, leaf):
        """This rank's part of a state leaf for the checkpoint: its
        pieces of the global value in the JAX layout (none when a lower
        rank holds the same shard)."""
        shape, spec = self._leaf_layout(path)
        mesh = self.mesh
        order = (qkv_col_order(path, self.model_cfg, mesh.shape["model"])
                 if self.arch == "gpt" else None)
        dtype = str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
        return Sharded(shape, dtype, shard_pieces(
            leaf.detach(), shape, spec, mesh.shape, mesh.rank, order))

    def _flat_state(self, dataloader=None) -> dict:
        items = flatten({"params": self.params, "opt": self.opt})
        if self.mesh is None:
            flat = {_keystr(path): leaf for path, leaf in items}
        else:
            flat = {_keystr(path): self._sharded(path, leaf)
                    for path, leaf in items}
        for k, v in self.guard.items():
            flat[f"guard/{k}"] = v
        flat["meta/global_step"] = np.int64(self.global_step)
        if dataloader is not None:
            sd = dataloader.state_dict()
            flat["data/cursor_json"] = np.frombuffer(
                json.dumps(sd, sort_keys=True).encode(), dtype=np.uint8)
        return flat

    def save_checkpoint(self, root: str, step: int, keep_last_n: int = 3,
                        dataloader=None, async_save: bool = False) -> str:
        """Atomically write ``root/step-<N>/`` -- the full train state,
        with ``dataloader.state_dict()`` when one is passed -- and rotate
        to the newest ``keep_last_n``. Returns the path.

        ``async_save=True`` copies the state to the host inline (so the
        saved values are exactly this step's) and commits on a background
        thread. At most one save is in flight per root; a background
        write error re-raises at the next save or
        :meth:`flush_checkpoints`. Call :meth:`flush_checkpoints` before
        the process exits. Over a mesh every rank calls it at the same
        step, each writing its own shard files."""
        self._ckpt_root = root
        state = self._flat_state(dataloader=dataloader)
        if async_save:
            return self._async_mgr(root, keep_last_n).save(state, step)
        return CheckpointManager(root, keep_last_n=keep_last_n).save(state,
                                                                     step)

    def _async_mgr(self, root: str, keep_last_n: int):
        """The per-root AsyncCheckpointManager (kept: in-flight tracking
        and error propagation must survive across calls)."""
        mgr = self._async_mgrs.get(root)
        if mgr is None:
            mgr = self._async_mgrs[root] = AsyncCheckpointManager(
                root, keep_last_n=keep_last_n)
        else:
            mgr.keep_last_n = keep_last_n
        return mgr

    def flush_checkpoints(self) -> None:
        """Block until every in-flight async commit lands; re-raise the
        first background write error after draining every root."""
        first_err = None
        for mgr in self._async_mgrs.values():
            try:
                mgr.wait()
            except CheckpointError as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def _latest(self, root: str):
        """``(step, state)`` of the newest valid checkpoint under
        ``root``, or None. Over a mesh the ranks agree on the step (the
        newest every rank verified; the oldest of their answers if they
        differ), and every rank reads the global values."""
        if self.world > 1:
            # every rank's commits land before any rank lists the steps
            self.flush_checkpoints()
            comm.barrier(self.mesh.world_group)
        mgr = CheckpointManager(root)
        found = mgr.latest()
        if self.world == 1:
            return None if found is None else (
                found[0], load_state_dict(found[1], verify=False))
        mine = -1 if found is None else found[0]
        agree = torch.tensor([mine, -mine], dtype=torch.int64,
                             device=self.device)
        comm.all_reduce(agree, comm.ReduceOp.MIN,
                        group=self.mesh.world_group)
        lo, hi = int(agree[0]), -int(agree[1])
        if lo != hi:
            print(f"[checkpoint] ranks found steps {lo}..{hi} under "
                  f"{root!r}; resuming every rank from {lo}",
                  file=sys.stderr, flush=True)
        if lo < 0:
            return None
        return lo, load_state_dict(mgr.step_dir(lo), verify=lo != mine)

    def load_checkpoint(self, root: str, dataloader=None):
        """Resume from the newest *valid* checkpoint under ``root`` (torn
        or corrupt steps are skipped loudly): params and optimizer, and,
        where present, the guard, the global step and the dataloader
        cursor; each missing group warns and takes its fresh default.
        Over a mesh every rank calls it and takes its shards of the
        global values, whatever layout or world wrote them. Returns the
        restored step, or None when no valid checkpoint exists."""
        self._ckpt_root = root
        found = self._latest(root)
        if found is None:
            return None
        step, state = found
        items = flatten({"params": self.params, "opt": self.opt})
        keys = [_keystr(path) for path, _ in items]
        missing = [k for k in keys if k not in state]
        if missing:
            raise CheckpointError(
                f"checkpoint under {root!r} does not match this trainer's "
                f"state tree; missing keys: {missing[:5]} (model/optimizer "
                "config changed since the checkpoint was written?)")
        for (path, leaf), k in zip(items, keys):
            want = (tuple(leaf.shape) if self.mesh is None
                    else tuple(self._leaf_layout(path)[0]))
            if tuple(state[k].shape) != want:
                raise CheckpointError(
                    f"checkpoint under {root!r}: {k} has shape "
                    f"{tuple(state[k].shape)}, this trainer {want}")
        if self.mesh is None:
            restored = unflatten(
                (path, torch.from_numpy(state[k]).to(device=leaf.device,
                                                      dtype=leaf.dtype))
                for (path, leaf), k in zip(items, keys))
        else:
            restored = self._shards_of(items, keys, state)
        self.params, self.opt = restored["params"], restored["opt"]
        self._restore_extras(root, step, state, dataloader)
        acct = self.telemetry
        if acct is not None:
            # telemetry continues the GLOBAL step count after a resume
            acct.step_offset = int(step)
        return step

    def _shards_of(self, items, keys, state):
        """This rank's shards of the checkpoint's global params and
        moments (``shard_params``: the qkv head-aligned, each dim cut by
        its spec)."""
        full = unflatten((path, state[k]) for (path, _), k in
                         zip(items, keys))
        mesh, cfg = self.mesh, self.model_cfg
        cut = {"params": shard_params(full["params"], cfg,
                                      self._layout.pspecs, mesh.shape,
                                      mesh.rank)}
        cut["opt"] = {m: shard_params(full["opt"][m], cfg,
                                      self._layout.ospecs, mesh.shape,
                                      mesh.rank) for m in ("m", "v")}
        cut["opt"]["step"] = torch.as_tensor(full["opt"]["step"])
        dst = dict(items)
        return unflatten((path, x.to(device=dst[path].device,
                                     dtype=dst[path].dtype))
                         for path, x in flatten(cut))

    def _restore_extras(self, root, step, state, dataloader) -> None:
        """Restore the train state beyond params and optimizer; each
        missing group is a loud warning and a fresh default, never a
        silent zero."""
        def warn(what, default):
            print(f"[checkpoint] WARNING: {root!r} step-{step} has no "
                  f"{what} (written before full-TrainState checkpoints?); "
                  f"resuming with {default}", file=sys.stderr)

        defaults = _guard_defaults(self.cfg)
        if all(f"guard/{k}" in state for k in defaults):
            host = {k: np.asarray(state[f"guard/{k}"]).astype(v.dtype)
                    for k, v in defaults.items()}
        else:
            warn("anomaly-guard/loss-scale state",
                 "a fresh scale + zeroed skip counters")
            host = defaults
        self.guard = {k: torch.tensor(v, device=self.device)
                      for k, v in host.items()}
        self._pending_guard = None
        self.anomaly.update({
            "skips_total": int(host["skips_total"]),
            "consecutive": int(host["skip_count"]),
            "last_skipped": False,
            "loss_scale": float(host["loss_scale"]),
        })
        if "rng/key" in state:
            print(f"[checkpoint] {root!r} step-{step}: ignoring rng/key (the "
                  "port has no framework RNG stream yet)", file=sys.stderr)
        if "meta/global_step" in state:
            self.global_step = int(np.asarray(state["meta/global_step"]))
        else:
            warn("global step", f"the checkpoint's step number ({step})")
            self.global_step = int(step)
        if dataloader is not None:
            if "data/cursor_json" in state:
                dataloader.load_state_dict(json.loads(
                    np.asarray(state["data/cursor_json"]).tobytes().decode()))
            else:
                warn("data-iterator cursor",
                     "the dataloader's current position (data may replay)")

    # -- preemption-aware graceful shutdown ------------------------------

    def enable_preemption_guard(self, root: str, dataloader=None,
                                keep_last_n: int = 3, guard=None):
        """Arm graceful preemption shutdown: SIGTERM/SIGUSR1 (or the
        ``PADDLE_FI_PREEMPT_AT_STEP`` drill) is latched and consumed at
        the next step boundary -- any in-flight async save is flushed, a
        just-in-time full-state checkpoint is written under ``root``, and
        :class:`TrainingPreempted` (a ``SystemExit`` with
        :data:`PREEMPTED_EXIT_CODE`) is raised. Over a mesh every rank
        arms it: the notice is all-reduced at each step boundary, so every
        rank checkpoints the same step. Returns the guard."""
        self._preempt_guard = (guard if guard is not None
                               else PreemptionGuard())
        self._preempt_ckpt = (root, dataloader, keep_last_n)
        self._ckpt_root = root
        return self._preempt_guard

    def _handle_preemption(self, loss=None):
        root, dataloader, keep_last_n = self._preempt_ckpt
        step = self.global_step
        why = self._preempt_guard.why or (
            "a peer rank's notice" if self.world > 1 else "notice")
        print(f"[preemption] {why}: flushing in-flight saves and writing "
              f"just-in-time checkpoint at step {step}", file=sys.stderr,
              flush=True)
        # the in-flight commit lands first (the series stays ordered); an
        # earlier commit's error must not stop the just-in-time save,
        # which is the zero-lost-steps guarantee
        try:
            self.flush_checkpoints()
        except CheckpointError as e:
            print(f"[preemption] WARNING: flushing async saves failed "
                  f"({e}); writing the just-in-time checkpoint anyway",
                  file=sys.stderr, flush=True)
        path = self.save_checkpoint(root, step, keep_last_n=keep_last_n,
                                    dataloader=dataloader)
        if self.cfg.telemetry:
            obs.counter("train_preemptions_total").inc()
            if obs.enabled():
                obs.emit({"kind": "event", "name": "preempted_checkpoint",
                          "step": int(step), "path": path, "why": why})
        raise TrainingPreempted(
            f"preempted ({why}): just-in-time checkpoint written at "
            f"step {step} ({path}); exiting {PREEMPTED_EXIT_CODE}",
            step=step, checkpoint_path=path, loss=loss)


    # -- telemetry ----------------------------------------------------------

    # process-wide trainer numbering: a second trainer in the same
    # process (eval alongside train) gets its own metric label and its
    # JSONL step records stay separable
    _trainer_ids = itertools.count()

    @property
    def telemetry(self):
        """This trainer's :class:`~paddle_tpu_torch.observability.
        StepAccounting` (created on first use; None only when
        ``cfg.telemetry`` is False)."""
        if not self.cfg.telemetry:
            return None
        if self._accounting is None:
            self._accounting = obs.StepAccounting(
                n_devices=self.world, device=self.device,
                trainer=str(next(HybridParallelTrainer._trainer_ids)))
        return self._accounting

    def telemetry_summary(self):
        """The step-accounting summary plus ``device_memory`` (the live
        watermark) and the trainer's :meth:`memory_plan`. Reads the time
        of every step still in flight on the card first (it waits for
        them: call it off the step path). None before the first
        recorded step or with telemetry off."""
        self._read_timings(block=True)
        acct = self._accounting
        if acct is None:
            return None
        out = acct.summary()
        out["device_memory"] = self._sample_memory()
        out["memory_plan"] = self.memory_plan()
        return out

    def _health_snapshot(self) -> dict:
        """The trainer's /healthz payload: last dispatched step, OOM
        proximity, the guard's state and the consistency check's
        (heartbeat age is added by the endpoint itself from
        $PADDLE_HEARTBEAT_FILE)."""
        return {
            "role": "trainer",
            "step": self.global_step,
            "oom_proximity_warned": self._oom_latched,
            "anomaly": dict(self.anomaly),
            "consistency_check": self._consistency is not None,
            "collective_watchdog_timeout_s": float(
                os.environ.get("PADDLE_COLLECTIVE_TIMEOUT_S", "0") or 0),
        }

    def memory_plan(self, compute_executable: bool = False):
        """The trainer's memory plan: the state breakdown (params / opt
        state bytes from the live tensors), the measured step plan, and
        the card's capacity. PyTorch has no compiled executable to
        analyse: ``compute_executable=True`` on CUDA arms a measurement
        of the NEXT step (``reset_peak_memory_stats`` before it,
        ``max_memory_allocated`` after, synchronised: that one step
        waits for the device), whose plan ``executable`` then holds
        under the JAX plan's keys with ``"source": "measured"``. On the
        CPU it stays None, as on a JAX backend without the analysis."""
        if (compute_executable and self._exec_plan is None
                and self.device.type == "cuda"):
            self._measure_next = True
        if self.mesh is None:
            params = obs.state_breakdown(self.params)
            opt = obs.state_breakdown(self.opt)
        else:   # global bytes from the full shapes, per device the shards
            lay = self._layout
            params = obs.state_breakdown(lay.shapes, lay.pspecs,
                                         self.mesh.shape)
            opt = obs.state_breakdown(
                {"m": lay.shapes, "v": lay.shapes, "step": self.opt["step"]},
                {"m": lay.ospecs, "v": lay.ospecs, "step": P()},
                self.mesh.shape)
        return {
            "state": {
                "params": params,
                "opt_state": opt,
                "total_per_device_bytes": (params["per_device_bytes"]
                                           + opt["per_device_bytes"]),
                "total_global_bytes": (params["global_bytes"]
                                       + opt["global_bytes"]),
            },
            "executable": self._exec_plan,
            "hbm_per_chip_bytes": self._hbm_capacity() or None,
        }

    def _measure_begin(self) -> int:
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        return torch.cuda.memory_allocated(self.device)

    def _measure_end(self, arg_bytes: int) -> None:
        """The measured step's plan: ``argument_bytes`` in use at its
        entry, ``temp_bytes`` its peak above that, ``output_bytes`` in
        use after it. The new state takes the place of the old, as a
        donated buffer does in the JAX plan, so ``alias_bytes`` is the
        output and ``peak_bytes`` (arg + out + temp - alias) is the
        measured peak."""
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        out = torch.cuda.memory_allocated(self.device)
        self._exec_plan = {
            "argument_bytes": arg_bytes, "output_bytes": out,
            "temp_bytes": peak - arg_bytes, "generated_code_bytes": 0,
            "alias_bytes": out, "peak_bytes": peak, "source": "measured"}
        self._measure_next = False

    def _hbm_capacity(self) -> int:
        if self._hbm_cap < 0:
            self._hbm_cap = int(obs.hbm_bytes(self.device) or 0)
        return self._hbm_cap

    def _sample_memory(self):
        """The live memory watermark of the trainer's device (the JAX
        package's all-devices aggregate: max + sum). A device without
        stats (the CPU) is probed once, not once a step."""
        if self._mem_devices is None:
            agg = obs.all_devices_memory_stats([self.device])
            self._mem_devices = [self.device] if agg else []
            return agg
        if not self._mem_devices:
            return None
        return obs.all_devices_memory_stats(self._mem_devices)

    def _check_oom_proximity(self, mem) -> None:
        """One warning per crossing: projected peak (live bytes + the
        measured step's temp bytes) >= oom_warn_fraction x capacity."""
        cap = self._hbm_capacity()
        if not cap:
            return
        risk = obs.oom_risk(
            (mem or {}).get("max", {}).get("bytes_in_use", 0),
            (self._exec_plan or {}).get("temp_bytes", 0),
            cap, self.cfg.oom_warn_fraction)
        if risk is None:
            return
        if risk["near_oom"] and not self._oom_latched:
            self._oom_latched = True
            obs.counter("oom_proximity_warnings_total").inc()
            print(f"[memory] WARNING: OOM proximity at step "
                  f"{self.global_step}: projected "
                  f"{risk['projected_bytes'] / 1e9:.2f} GB >= "
                  f"{risk['fraction']:.0%} of "
                  f"{risk['capacity_bytes'] / 1e9:.2f} GB per-chip HBM "
                  f"(headroom {risk['headroom_bytes'] / 1e9:.2f} GB)",
                  file=sys.stderr, flush=True)
            if obs.enabled():
                obs.emit({"kind": "event", "name": "oom_proximity",
                          "step": int(self.global_step), **risk})
        elif not risk["near_oom"]:
            self._oom_latched = False

    def _step_begin(self):
        """Where a step's time starts: None with telemetry off, on CUDA
        an event recorded on the stream (it fires when the device
        reaches the step), else the host clock."""
        if not self.cfg.telemetry:
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _step_end(self, t0, t) -> None:
        """Account one dispatched step of ``t``'s tokens: on the CPU at
        once (the host wall of the dispatch), on CUDA once its end event
        has fired (:meth:`_read_timings`)."""
        tokens = int(t.numel())
        if self.mesh is not None:     # the global batch's, as JAX counts
            tokens *= self.mesh.size(_LOSS_AXES)
        if not isinstance(t0, torch.cuda.Event):
            self._record_step(time.perf_counter() - t0, tokens)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._timings.append((t0, end, tokens))
        self._read_timings(block=False)

    def _read_timings(self, block: bool) -> None:
        """Record the CUDA steps whose end event has fired, in order;
        ``block`` waits for the rest (never on the step path). With the
        guard on, a step has always ended by the time the next one is
        dispatched, so steps are recorded one step late."""
        while self._timings:
            start, end, tokens = self._timings[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._timings.popleft()
            self._record_step(start.elapsed_time(end) / 1e3, tokens)

    def _record_step(self, dur_s, tokens) -> None:
        acct = self.telemetry
        if acct.step >= 1 and not self._flops_published:
            # published once, after the first step, as in the JAX
            # package; PyTorch has no cost model, so the FLOPs are always
            # the analytic 6NT estimate
            if obs.enabled():
                obs.emit({"kind": "event", "name": "memory_plan",
                          "trainer": acct.trainer,
                          "plan": self.memory_plan()})
            acct.set_flops(6.0 * self.num_params() * tokens, "analytic_6NT")
            self._flops_published = True
        mem = self._sample_memory()
        acct.on_step(dur_s, tokens=tokens, memory=mem)
        if mem or self._hbm_capacity():
            # with a known capacity but no live stats (a CPU drill via
            # PADDLE_HBM_BYTES_PER_CHIP) the check still runs against a
            # zero watermark
            self._check_oom_proximity(mem)
