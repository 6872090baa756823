"""Per-train-step accounting: step time, first-step split, tokens/sec,
MFU (port of ``paddle_tpu.observability.step_stats``).

What a training run watches is one line per step — wall time,
throughput, utilisation — and that is what this module computes and
streams to the per-worker JSONL sink.

Methodology:

- **step time** is host wall-clock between dispatch entry and return.
  Steps are *not* force-synchronized: CUDA runs the step asynchronously,
  and under back-pressure (the caching allocator, the guard's lagged
  read) the host dispatch rate converges to the device step rate, so
  windowed averages are device-accurate while adding zero sync
  overhead. The **first** step (cold caches, first allocations) is
  split out as ``compile_ms`` (the JAX package's name: there it is the
  XLA compile) and excluded from the steady-state histogram.
- **MFU** divides model FLOPs/step by (step time x per-device peak,
  ``hw.peak_flops``). PyTorch has no cost model, so the trainer
  publishes the analytic ``6 * params * tokens`` estimate, flagged
  ``flops_source="analytic_6NT"``.
- **device memory** comes from ``torch.cuda.memory_stats`` under the
  JAX package's keys; the CPU has none, and absent stats are omitted,
  never faked.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from . import sink
from .hw import peak_flops
from .metrics import registry

__all__ = ["StepAccounting", "device_memory_stats"]


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` for a CUDA
    ``device`` (default: the current one) from
    ``torch.cuda.memory_stats``, or None for the CPU or when no CUDA
    device is there. ``bytes_in_use`` and ``peak_bytes_in_use`` are the
    caching allocator's ``allocated_bytes.all.current`` and ``.peak``
    (what ``memory_allocated`` and ``max_memory_allocated`` read) and
    ``bytes_limit`` the card's ``total_memory``. The JAX key
    ``largest_alloc_size`` is left out: the allocator keeps no largest
    single allocation."""
    import torch

    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:
        return None
    if not stats:
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(limit)}


class StepAccounting:
    """Accumulates per-step timing for one trainer and emits telemetry.

    ``on_step(dur_s, tokens=...)`` is the only hot-path call; everything
    it does is a few float ops, two metric updates, and (when the sink
    is enabled) one JSONL line. FLOPs/step and device handles are set
    once by the owner (the trainer) — this class never touches the
    device on the hot path.
    """

    def __init__(self, flops_per_step: Optional[float] = None,
                 flops_source: str = "unset", n_devices: int = 1,
                 device=None, window: int = 64, trainer: str = "0"):
        self.step = 0
        self.compile_ms: Optional[float] = None
        self.flops_per_step = flops_per_step
        self.flops_source = flops_source
        self.n_devices = max(1, int(n_devices))
        self._device = device
        self._peak: Optional[float] = None
        # per-trainer label: two trainers in one process (train + eval)
        # must not interleave into one histogram / flap shared gauges
        self.trainer = str(trainer)
        # resume continuity: set to the restored checkpoint step so JSONL
        # step numbers and the watcher heartbeat carry the GLOBAL step
        # after an elastic relaunch, not a from-1 local count
        self.step_offset = 0
        self._hist = registry().histogram("step_time_ms",
                                          trainer=self.trainer)
        self._tok_gauge = registry().gauge("tokens_per_sec",
                                           trainer=self.trainer)
        self._mfu_gauge = registry().gauge("mfu", trainer=self.trainer)
        # rolling window for the smoothed rates reported per step
        self._window = max(1, int(window))
        self._recent: list = []
        self.last_record: Optional[Dict[str, Any]] = None

    # -- configuration -----------------------------------------------------

    def set_flops(self, flops_per_step: Optional[float], source: str) -> None:
        if flops_per_step:
            self.flops_per_step = float(flops_per_step)
            self.flops_source = source

    def _peak_flops_total(self) -> float:
        if self._peak is None:
            self._peak = peak_flops(self._device) * self.n_devices
        return self._peak

    # -- accounting --------------------------------------------------------

    def on_step(self, dur_s: float, tokens: Optional[int] = None,
                loss: Optional[float] = None,
                memory: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        """Record one completed step of ``dur_s`` seconds covering
        ``tokens`` tokens; returns (and JSONL-emits) the step record."""
        self.step += 1
        global_step = self.step_offset + self.step
        dur_ms = dur_s * 1e3
        rec: Dict[str, Any] = {"kind": "step", "step": global_step,
                               "trainer": self.trainer,
                               "step_time_ms": round(dur_ms, 3)}
        if self.step == 1:
            # the first step pays cold caches and first allocations;
            # keep it out of the steady-state distribution
            self.compile_ms = round(dur_ms, 3)
            rec["compile_ms"] = self.compile_ms
            registry().gauge("compile_time_ms",
                             trainer=self.trainer).set(dur_ms)
        else:
            self._hist.observe(dur_ms)
            self._recent.append((dur_s, tokens or 0))
            if len(self._recent) > self._window:
                self._recent.pop(0)
            span_s = sum(d for d, _ in self._recent)
            span_tok = sum(t for _, t in self._recent)
            if tokens:
                tok_rate = span_tok / span_s if span_s > 0 else 0.0
                rec["tokens_per_sec"] = round(tok_rate, 1)
                self._tok_gauge.set(tok_rate)
            if self.flops_per_step and span_s > 0:
                steps_per_s = len(self._recent) / span_s
                mfu = (self.flops_per_step * steps_per_s
                       / self._peak_flops_total())
                rec["mfu"] = round(mfu, 6)
                rec["flops_source"] = self.flops_source
                self._mfu_gauge.set(mfu)
        if loss is not None:
            rec["loss"] = float(loss)
        if memory:
            rec["device_memory"] = memory
            # `memory` is either one device's raw stats dict or the
            # all-devices aggregate ({n_devices_with_stats, max, sum})
            # from observability.memory.all_devices_memory_stats
            mx = memory.get("max", memory)
            registry().gauge("device_bytes_in_use",
                             trainer=self.trainer).set(
                mx.get("bytes_in_use", 0))
            if "sum" in memory:
                registry().gauge("device_bytes_in_use_sum",
                                 trainer=self.trainer).set(
                    memory["sum"].get("bytes_in_use", 0))
        self.last_record = rec
        sink.emit(rec)
        # enrich the elastic watcher's hang signal: heartbeat carries the
        # last completed GLOBAL step (no-op unless launched with a
        # heartbeat file) plus this rank's ROLLING step time, which
        # feeds the watcher's straggler detector (a rank above the
        # cross-rank median by a configured ratio for M windows is
        # flagged). Only the primary trainer beats — a secondary (eval)
        # trainer must not flap the reported step between two unrelated
        # counters.
        if self.trainer == "0":
            if self._recent:
                span_s = sum(d for d, _ in self._recent)
                rolling_ms = span_s / len(self._recent) * 1e3
            else:
                rolling_ms = dur_ms  # first (compile) step: best known
            from ..distributed.launch.watcher import touch_heartbeat

            touch_heartbeat(step=global_step, step_ms=rolling_ms)
        return rec

    def summary(self) -> Dict[str, Any]:
        h = self._hist.snapshot()
        out = {"steps": self.step, "compile_ms": self.compile_ms,
               "step_time_ms": h,
               "tokens_per_sec": self._tok_gauge.value,
               "mfu": self._mfu_gauge.value,
               "flops_per_step": self.flops_per_step,
               "flops_source": self.flops_source}
        return out
