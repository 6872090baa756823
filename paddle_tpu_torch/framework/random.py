"""RNG state (port of ``paddle_tpu.framework.random``).

A key is an explicit ``(seed, offset)`` pair of integers below ``2**64``,
the Philox key and counter of the flash kernels' attention dropout
(``ops/kernels/philox.py``). The global ``Generator`` draws keys from a
``torch.Generator`` of its own (CPU, seeded by ``seed``), so nothing here
reads or advances PyTorch's global RNG, and a key is the same on the CPU
and on the card. Inside an ``rng_context(key)`` keys are that key with a
counter folded in (``philox.fold_in``), as the JAX package's context
folds one into its key: a replay of the same calls draws the same keys.
"""
from __future__ import annotations

import threading

import torch

from ..ops.kernels.philox import fold_in

__all__ = ["Generator", "default_generator", "seed", "rng_context",
           "next_rng_key", "get_rng_state", "set_rng_state"]


class Generator:
    """The key stream: ``next_key()`` draws ``(seed, offset)`` from a CPU
    ``torch.Generator`` this object owns."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gen = torch.Generator().manual_seed(self._seed)
        self._lock = threading.Lock()

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._gen.manual_seed(self._seed)
        return self

    @property
    def initial_seed(self) -> int:
        return self._seed

    def next_key(self) -> tuple:
        with self._lock:
            w = torch.randint(0, 2 ** 32, (4,), dtype=torch.int64,
                              generator=self._gen).tolist()
        return (w[0] | (w[1] << 32), w[2] | (w[3] << 32))

    def get_state(self):
        with self._lock:
            return self._gen.get_state()

    def set_state(self, state):
        with self._lock:
            self._gen.set_state(state)


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int):
    """``paddle.seed``: reseeds the global generator."""
    return _default_generator.manual_seed(s)


_tls = threading.local()


class rng_context:
    """Keys derived from ``key`` by folding in a counter, in place of the
    global generator's, while the context is active."""

    def __init__(self, key):
        self.key = tuple(int(x) for x in key)
        self.count = 0

    def next_key(self) -> tuple:
        k = fold_in(self.key, self.count)
        self.count += 1
        return k

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()


def next_rng_key() -> tuple:
    """A fresh key: from the innermost ``rng_context`` if one is active,
    else from the global generator."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1].next_key()
    return _default_generator.next_key()


def get_rng_state():
    return [_default_generator.get_state()]


def set_rng_state(state):
    _default_generator.set_state(state[0])
