"""The framework layer (port of ``paddle_tpu.framework``): the random
stream."""
from . import random
from .random import get_rng_state, seed, set_rng_state

__all__ = ["random", "seed", "get_rng_state", "set_rng_state"]
