"""Philox4x32-10 in plain PyTorch: the keep bits of the flash kernels'
attention dropout (``csrc/philox.cuh``), bit for bit.

A dropout call is keyed by ``(seed, offset)``, two integers below
``2**64``. With ``x' = ((x >> 4) << 3) | (x & 7)`` (``x`` without its
bit 3) and ``bit(x) = (x >> 3) & 1``, element ``(b, h, i, j)`` of the
``(B, H, Sq, Sk)`` probabilities is kept when word
``2 * bit(i) + bit(j)`` of

    philox4x32_10(counter=(j', i', b * H + h, offset % 2**32),
                  key=(seed % 2**32, (seed >> 32) ^ (offset >> 32)))

is below ``threshold(dropout_p) = floor((1 - dropout_p) * 2**32)``, with
``dropout_p`` taken as float32 (the C entries' type). One call gives the
four elements ``{a, a + 8} x {c, c + 8}`` (``a``, ``c`` with bit 3
clear), four entries that one thread of a wgmma accumulator fragment
holds whether its rows are queries or keys. The counter is the element's
logical index, so the bits do not depend on a kernel's tiling, and the
backward kernels regenerate the forward's. The plain versions of the
kernels (``flash_attention_packed``, ``flash_attention``) rebuild the
mask here.

uint32 words live in int64 tensors: the product of two words is below
``2**64``, and the wrapped low 64 bits of an int64 product hold it whole,
so ``>> 32`` and ``& 0xFFFFFFFF`` give its high and low words.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["philox4x32_10", "threshold", "key_words", "keep_mask",
           "fold_in"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (four int64 tensors or ints, each a
    uint32, broadcast together) under ``key`` (two uint32 ints). Returns
    the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in counter)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def threshold(dropout_p: float) -> int:
    """The keep threshold of ``dropout_p`` in (0, 1), as the C entries
    compute it: ``dropout_p`` rounded to float32, then ``(1 - p) * 2**32``
    in double, truncated."""
    keep = 1.0 - float(np.float32(dropout_p))
    return _MASK if keep >= 1.0 else int(keep * 4294967296.0)


def key_words(rng) -> tuple:
    """``(seed, offset)`` -> ``(k0, k1, counter word 3)``."""
    seed, offset = (int(x) % 2 ** 64 for x in rng)
    return (seed & _MASK, (seed >> 32) ^ (offset >> 32), offset & _MASK)


def keep_mask(rng, dropout_p: float, shape, device=None):
    """The kernels' keep mask of a ``(B, H, Sq, Sk)`` dropout call keyed
    by ``rng = (seed, offset)``: bool, ``shape``."""
    b, h, sq, sk = shape
    k0, k1, off = key_words(rng)
    gi, gj = -(-sq // 16), -(-sk // 16)     # 16-row and 16-column blocks
    bh = torch.arange(b * h, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(8 * gi, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(8 * gj, dtype=torch.int64, device=device)[None, None]
    words = philox4x32_10((j, i, bh, off), (k0, k1))      # at (j', i')
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    keep = words < threshold(dropout_p)     # (B*H, 8 gi, 8 gj, 4)
    # i' = 8 g + r and word 2 bit(i) + bit(j): i = 16 g + 8 bit(i) + r
    keep = keep.reshape(b * h, gi, 8, gj, 8, 2, 2).permute(0, 1, 5, 2, 3, 6, 4)
    return keep.reshape(b, h, 16 * gi, 16 * gj)[..., :sq, :sk]


def fold_in(rng, data: int) -> tuple:
    """A new ``(seed, offset)`` from ``rng`` and an integer: Philox of
    counter ``(data mod 2**32, data >> 32 mod 2**32, offset mod 2**32,
    offset >> 32)`` under the seed's two words, the four output words
    read as ``(seed', offset')``."""
    seed, offset = (int(x) % 2 ** 64 for x in rng)
    data = int(data) % 2 ** 64
    w = [int(x) for x in philox4x32_10(
        (data & _MASK, data >> 32, offset & _MASK, offset >> 32),
        (seed & _MASK, seed >> 32))]
    return (w[0] | (w[1] << 32), w[2] | (w[3] << 32))
