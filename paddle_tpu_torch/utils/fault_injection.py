"""Fault injection for drills (port of ``paddle_tpu.utils.fault_injection``):
the numerical-anomaly point and the preemption point.

``PADDLE_FI_NAN_AT_STEP`` names the trainer steps whose loss is
multiplied by NaN, poisoning the loss and, through the chain rule, every
grad; the anomaly guard must then skip the step. Grammar: ``"7"`` fires
at step 7 only, ``"7+"`` at 7 and every later step, and comma lists
combine.

``PADDLE_FI_PREEMPT_AT_STEP`` (one integer step) makes
``preempt_at_step`` answer True once, at the boundary after that step:
the ``PreemptionGuard`` then sends a real SIGTERM to its own process.
It needs ``PADDLE_FI_DIR``, where a marker file remembers the firing
across the relaunch (which inherits the environment); without it the
point is ignored, loudly.
"""
from __future__ import annotations

import os
import sys

__all__ = ["nan_at_step", "preempt_at_step"]

# specs already warned about (preempt_at_step is consulted every step)
_WARNED_MALFORMED_PREEMPT: set = set()


def _fi_dir() -> str | None:
    d = os.environ.get("PADDLE_FI_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
    return d or None


def _fire_once(marker: str) -> bool:
    """Atomically claim a fire-once marker; True exactly once per drill
    (across processes and restarts: O_EXCL in ``PADDLE_FI_DIR``)."""
    d = _fi_dir()
    if d is None:
        return True  # no dir -> no cross-restart memory; caller beware
    try:
        fd = os.open(os.path.join(d, marker),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def nan_at_step(step: int) -> bool:
    """Should ``step`` be poisoned with NaN?"""
    spec = os.environ.get("PADDLE_FI_NAN_AT_STEP")
    if not spec:
        return False
    step = int(step)
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.endswith("+"):
            if step >= int(part[:-1]):
                return True
        elif int(part) == step:
            return True
    return False


def _warn_preempt_once(target: str, msg: str) -> None:
    if target not in _WARNED_MALFORMED_PREEMPT:
        _WARNED_MALFORMED_PREEMPT.add(target)
        print(msg, file=sys.stderr)


def preempt_at_step(step: int) -> bool:
    """Should the guard send a SIGTERM to this process at the boundary
    after ``step``? Fires once per drill (a marker in ``PADDLE_FI_DIR``
    keeps the relaunched worker from preempting again)."""
    target = os.environ.get("PADDLE_FI_PREEMPT_AT_STEP")
    if not target:
        return False
    try:
        target_step = int(target)
    except ValueError:
        _warn_preempt_once(target, "[fault-injection] ignoring malformed "
                           f"PADDLE_FI_PREEMPT_AT_STEP={target!r} (expected "
                           "a single integer step)")
        return False
    if target_step != int(step):
        return False
    if _fi_dir() is None:
        # without the marker dir every relaunched generation would
        # re-preempt at the same boundary, forever
        _warn_preempt_once(target, "[fault-injection] ignoring "
                           "PADDLE_FI_PREEMPT_AT_STEP: PADDLE_FI_DIR is "
                           "required for its fire-once marker")
        return False
    if not _fire_once(f"preempt_at_step-{target}"):
        return False
    print(f"[fault-injection] SIGTERM (preemption notice) at step {step}",
          file=sys.stderr, flush=True)
    return True
