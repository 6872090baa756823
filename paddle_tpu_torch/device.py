"""Device resolution for the port's entry points: ``cuda`` unless the
caller asks for the CPU, and never a silent fall back to the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA device, and raises when there is
    none; an explicit device (``"cpu"``, ``"cuda:1"``) is taken as
    given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
