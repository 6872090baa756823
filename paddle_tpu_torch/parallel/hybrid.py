"""Single-device trainer for GPT and LLaMA (port of
``paddle_tpu.parallel.hybrid``).

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

Only the single-device branch of the JAX trainer is ported. These raise
``NotImplementedError``, naming the slice that brings them: any mesh axis
(``dp``, ``mp``, ``pp``, ``sharding``, ``sep``) above 1 (multi-device),
``loss_scaling``, checkpoints and preemption, and telemetry, the memory
plan and the HTTP endpoint. ``TrainerConfig`` keeps every field and
default of the JAX package's; ``telemetry`` and ``compile_ledger`` are
accepted and record nothing in this slice (PyTorch runs eagerly, there
is no compile to ledger).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..io.packing import positions_from_segment_ids
from ..models.llama import LlamaConfig
from ..utils import fault_injection as fi
from ..utils.tree import flatten, tree_map, unflatten
from . import llama_core
from . import transformer_core as core

__all__ = ["DIVERGENCE_EXIT_CODE", "NumericalDivergenceError",
           "TrainerConfig", "HybridParallelTrainer", "global_norm",
           "adamw_init", "adamw_update"]

# exit code for a script that lets NumericalDivergenceError end it (the
# JAX package's elastic watcher classifies it as "divergence")
DIVERGENCE_EXIT_CODE = 117


class NumericalDivergenceError(RuntimeError):
    """Raised once the anomaly guard has skipped
    ``TrainerConfig.max_consecutive_skips`` steps in a row. Checkpoints
    are not ported, so no state is rolled back (``rolled_back_to`` is
    None), as in the JAX package without a checkpoint root."""

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
    # False | True/"full" ("dots" and "names:a,b" are not ported yet)
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
    stepf = step.float()
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
            if cfg.grad_clip else 1.0)
    lr = _lr_at(cfg, stepf)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        step_v = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            step_v = step_v + cfg.weight_decay * p.float()
        return (p.float() - lr * step_v).to(p.dtype), m, v

    paths = [path for path, _ in flatten(params)]
    out = [upd(*leaves) for leaves in zip(*(
        [x for _, x in flatten(t)] for t in (params, grads, opt["m"],
                                             opt["v"])))]
    new_p, new_m, new_v = (unflatten(zip(paths, col)) for col in zip(*out))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm


def _guard_defaults(cfg: TrainerConfig) -> dict:
    """Fresh anomaly-guard state (kept on the device by the trainer)."""
    return {
        "loss_scale": np.float32(
            cfg.init_loss_scale if cfg.loss_scaling else 1.0),
        "good_steps": np.int32(0),
        "skip_count": np.int32(0),
        "skips_total": np.int32(0),
    }


def _arch_for(model_cfg):
    """The functional core for a model config's family: ``(init, loss,
    name)``, GPT by default, LLaMA for a ``LlamaConfig``."""
    if isinstance(model_cfg, LlamaConfig):
        return llama_core.llama_init, llama_core.llama_loss, "llama"
    return core.gpt_init, core.gpt_loss, "gpt"


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported yet; it comes with {slice_name}")


class HybridParallelTrainer:
    """One-device GPT or LLaMA trainer on ``device`` (CUDA unless
    ``"cpu"`` is asked for).

    Usage:
        t = HybridParallelTrainer(gpt_345m(), TrainerConfig())
        loss = t.step(tokens, labels)
    """

    def __init__(self, model_cfg, cfg: TrainerConfig, device=None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self._init_fn, self._loss_fn, self.arch = _arch_for(model_cfg)
        self._validate()
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = tree_map(lambda t: t.to(self.device),
                               self._init_fn(model_cfg, gen))
        self.opt = adamw_init(self.params)
        self.guard = {k: torch.tensor(v, device=self.device)
                      for k, v in _guard_defaults(cfg).items()}
        self.global_step = 0          # data-consumption steps dispatched
        self._pending_guard = None    # (step, host flags, CUDA event)
        self.last_grad_norm = None    # the last step's global grad norm
        self.anomaly = {"skips_total": 0, "consecutive": 0,
                        "last_skipped": False,
                        "loss_scale": float(self.guard["loss_scale"])}

    def _validate(self):
        cfg = self.cfg
        if cfg.pp_schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown pp_schedule: {cfg.pp_schedule!r}")
        if cfg.vpp < 1:
            raise ValueError(f"vpp must be >= 1, got {cfg.vpp}")
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
        axes = {a: getattr(cfg, a) for a in ("dp", "mp", "pp", "sharding",
                                              "sep")}
        if any(n != 1 for n in axes.values()) or cfg.vpp != 1:
            _not_ported(f"a mesh axis above 1 ({axes}, vpp={cfg.vpp})",
                        "the multi-device slice")
        if cfg.loss_scaling:
            _not_ported("loss_scaling", "a later training slice")
        if cfg.consistency_check_every:
            _not_ported("the cross-rank consistency check",
                        "the multi-device slice")
        if cfg.http_port is not None:
            _not_ported("the trainer's HTTP ops endpoint",
                        "the training telemetry slice")
        core._remat_wrap(None, cfg.remat)   # an unported policy raises now

    # -- the step -----------------------------------------------------------
    def loss_and_grads(self, params, tokens, labels, poison=1.0, extras=()):
        """``(loss * poison, grads)`` of the family's loss at ``params``:
        the loss detached, the grads a tree like ``params``. ``extras`` is
        ``(segment_ids, positions)`` in packed mode (GPT), else empty."""
        paths, leaves = zip(*((path, p.detach().requires_grad_(True))
                              for path, p in flatten(params)))
        kw = dict(zip(("segment_ids", "positions"), extras))
        raw = self._loss_fn(self.model_cfg, unflatten(zip(paths, leaves)),
                            tokens, labels,
                            compute_dtype=self.cfg.compute_dtype,
                            remat=self.cfg.remat, **kw) * poison
        grads = torch.autograd.grad(raw, leaves)
        return raw.detach(), unflatten(zip(paths, grads))

    def _step_fn(self, tokens, labels, extras, poison):
        """value-and-grad, AdamW, and the guard's select; returns
        ``(params, opt, guard, loss, grad_norm, skipped)``, all on the
        device."""
        cfg, params, opt, guard = self.cfg, self.params, self.opt, self.guard
        loss, grads = self.loss_and_grads(params, tokens, labels, poison,
                                          extras)
        new_p, new_opt, gnorm = adamw_update(cfg, params, grads, opt)
        del grads   # one state's worth of memory less at the commit below
        if not cfg.anomaly_guard:
            return (new_p, new_opt, guard, loss, gnorm,
                    torch.zeros((), dtype=torch.bool, device=loss.device))
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)

        def commit(new, old):
            return tree_map(lambda n, o: torch.where(finite, n, o), new, old)

        new_p = commit(new_p, params)
        new_opt = commit(new_opt, opt)
        skipped = ~finite
        new_guard = {
            "loss_scale": guard["loss_scale"],
            "good_steps": torch.where(finite, guard["good_steps"] + 1,
                                      0).to(torch.int32),
            "skip_count": torch.where(finite, 0, guard["skip_count"] + 1
                                      ).to(torch.int32),
            "skips_total": (guard["skips_total"]
                            + skipped.to(torch.int32)),
        }
        return new_p, new_opt, new_guard, loss, gnorm, skipped

    # -- API ----------------------------------------------------------------
    def shard_batch(self, tokens, labels):
        """Host batches -> int64 tensors on the trainer's device."""
        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long).to(
                self.device)

        return put(tokens), put(labels)

    def _packed_extras(self, segment_ids, positions):
        """Validate the packed-mode extras and put them on the device as
        int32: ``()`` in plain mode, ``(segment_ids, positions)`` in
        packed mode, with positions derived from the ids when missing.
        Raises where the call disagrees with ``cfg.packed_sequences``
        (silently ignoring ids would train across documents)."""
        if not self.cfg.packed_sequences:
            self._no_packed_extras("step()", segment_ids, positions)
            return ()
        if segment_ids is None:
            raise ValueError(
                "packed_sequences=True: step() needs segment_ids (and "
                "positions) -- produce batches with io.packing")
        seg = np.asarray(segment_ids, np.int32)
        if positions is None:
            positions = positions_from_segment_ids(seg)

        def put(x):
            return torch.as_tensor(np.asarray(x, np.int32)).to(self.device)

        return put(seg), put(positions)

    def step(self, tokens, labels, segment_ids=None, positions=None):
        extras = self._packed_extras(segment_ids, positions)
        t, l = self.shard_batch(tokens, labels)
        return self._dispatch_step(t, l, extras)

    def step_presharded(self, tokens_dev, labels_dev, segment_ids_dev=None,
                        positions_dev=None):
        """One train step over batches already on the device (the tight
        loop of a benchmark); returns the loss as a device tensor. Packed
        mode takes the device-resident segment ids and positions too."""
        if self.cfg.packed_sequences:
            if segment_ids_dev is None or positions_dev is None:
                raise ValueError(
                    "packed_sequences=True: step_presharded() needs "
                    "device-resident segment_ids and positions")
            extras = (segment_ids_dev, positions_dev)
        else:
            self._no_packed_extras("step_presharded()", segment_ids_dev,
                                   positions_dev)
            extras = ()
        return self._dispatch_step(tokens_dev, labels_dev, extras)

    def _no_packed_extras(self, what, segment_ids, positions):
        if segment_ids is not None or positions is not None:
            raise ValueError(
                f"{what} got segment_ids/positions but "
                "TrainerConfig.packed_sequences is False -- the ids would "
                "be silently ignored; build the trainer with "
                "packed_sequences=True")

    def _dispatch_step(self, t, l, extras=()):
        self.global_step += 1
        (self.params, self.opt, self.guard, loss, gnorm, skipped) = (
            self._step_fn(t, l, extras, self._poison_for(self.global_step)))
        self.last_grad_norm = gnorm
        if self.cfg.anomaly_guard:
            prev = self._pending_guard
            # the new step is enqueued before the previous one's flag is
            # read, so the read waits for that step only
            self._pending_guard = (self.global_step,
                                   *self._guard_snapshot(skipped))
            if prev is not None:
                self._resolve_guard(prev)
        return loss

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
            return
        consec = int(consec)
        self.anomaly["skips_total"] += 1
        self.anomaly["consecutive"] = consec
        budget = self.cfg.max_consecutive_skips
        if budget and consec >= budget:
            raise NumericalDivergenceError(
                f"{consec} consecutive non-finite train steps (budget "
                f"{budget}) at step {step}: training state is diverging; "
                "no checkpoint root known, state NOT rolled back")

    def anomaly_state(self) -> dict:
        """Resolve any in-flight step and return the host mirror of the
        guard: ``{skips_total, consecutive, last_skipped, loss_scale}``.
        May raise :class:`NumericalDivergenceError`."""
        pending, self._pending_guard = self._pending_guard, None
        if pending is not None:
            self._resolve_guard(pending)
        return dict(self.anomaly)

    def num_params(self) -> int:
        return int(sum(p.numel() for _, p in flatten(self.params)))

    # -- not ported in this slice --------------------------------------------
    @property
    def telemetry(self):
        _not_ported("trainer telemetry", "the training telemetry slice")

    def telemetry_summary(self):
        _not_ported("trainer telemetry", "the training telemetry slice")

    def memory_plan(self, compute_executable: bool = False):
        _not_ported("the memory plan", "the training telemetry slice")

    def save_checkpoint(self, root, step, keep_last_n=3, dataloader=None,
                        async_save=False):
        _not_ported("checkpoints", "the trainer durability slice")

    def load_checkpoint(self, root, dataloader=None):
        _not_ported("checkpoints", "the trainer durability slice")

    def enable_preemption_guard(self, root, dataloader=None, keep_last_n=3,
                                guard=None):
        _not_ported("the preemption guard", "the trainer durability slice")

    def enable_consistency_check(self, every, dataloader=None,
                                 exchange_dir=None, timeout_s=None):
        _not_ported("the cross-rank consistency check",
                    "the multi-device slice")
