"""The nn API (port of ``paddle_tpu.nn``): the attention functionals.
Layers are PyTorch's own ``torch.nn`` modules."""
from . import functional

__all__ = ["functional"]
