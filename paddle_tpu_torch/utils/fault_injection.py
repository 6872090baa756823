"""Fault injection for drills (port of ``paddle_tpu.utils.fault_injection``):
the numerical-anomaly point only so far.

``PADDLE_FI_NAN_AT_STEP`` names the trainer steps whose loss is
multiplied by NaN, poisoning the loss and, through the chain rule, every
grad; the anomaly guard must then skip the step. Grammar: ``"7"`` fires
at step 7 only, ``"7+"`` at 7 and every later step, and comma lists
combine.
"""
from __future__ import annotations

import os

__all__ = ["nan_at_step"]


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
