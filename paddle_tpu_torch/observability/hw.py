"""Per-card peak rates and memory capacity (port of
``paddle_tpu.observability.hw`` for the NVIDIA cards the port runs on).

One table for the whole port: the trainer's per-step MFU
(``step_stats.StepAccounting``) and ``chip_smoke.py``'s MFU and kernel
bounds divide by the same peaks, so their utilisation numbers compare.
Values are the published dense peaks of each part (NVIDIA data sheets):
bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, and HBM
bytes/s. The capacity table feeds the memory plan and the OOM-proximity
check (:mod:`.memory`). A device is matched on the name
``torch.cuda.get_device_name()`` returns, first match wins.
"""
from __future__ import annotations

import os

__all__ = ["PEAKS", "PEAK_FLOPS", "peak_flops", "HBM_BYTES", "hbm_bytes",
           "device_name", "peaks_for"]

# published dense peaks per part; "H100 PCIe" comes before the SXM part
# ("H100"), whose name it contains
PEAKS = {
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "hbm": 2.0e12},
    "H100": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},   # SXM
}

# dense bf16 peak FLOP/s per part (the MFU denominator)
PEAK_FLOPS = {name: p["bf16"] for name, p in PEAKS.items()}

_DEFAULT = PEAKS["H100"]["bf16"]   # an unrecognized device (the CPU)

# device memory capacity in bytes per part
HBM_BYTES = {
    "H100 PCIe": 80 << 30,
    "H100": 80 << 30,
}

# test/drill override: a fake capacity lets the OOM-proximity path run
# end to end where the device has no known capacity (the CPU)
ENV_HBM_OVERRIDE = "PADDLE_HBM_BYTES_PER_CHIP"


def device_name(device=None) -> str:
    """The name of ``device`` (a ``torch.device``, an index or a name
    string; default the current CUDA device), "" for the CPU or when no
    CUDA device is there."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.cuda.current_device()
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type != "cuda":
        return ""
    return torch.cuda.get_device_name(dev)


def peaks_for(name: str):
    """The published peaks of the part ``name`` names, or None."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    return None


def peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s for ``device`` (default: the current CUDA
    device). An unrecognized device, the CPU included, falls back to the
    H100 SXM number, so MFU stays a defined (if tiny) ratio on the CPU
    rather than a divide-by-zero."""
    p = peaks_for(device_name(device))
    return p["bf16"] if p else _DEFAULT


def hbm_bytes(device=None):
    """Device memory capacity in bytes for ``device``, or None when it
    has no known capacity (the CPU). Unlike :func:`peak_flops` there is
    no silent default: an OOM-proximity warning against a guessed
    capacity would be noise. ``PADDLE_HBM_BYTES_PER_CHIP`` overrides
    (tests, drills)."""
    env = os.environ.get(ENV_HBM_OVERRIDE, "").strip()
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    name = device_name(device)
    for key, val in HBM_BYTES.items():
        if key in name:
            return val
    return None
