"""Ring attention: sequence (context) parallelism over a mesh axis (port
of ``paddle_tpu.ops.pallas.ring_attention``).

Each rank of the ring (the mesh's ``"sep"`` group) holds a query shard
and its K/V shard; the K/V shards travel one hop a step
(``communication.ring_shift``), and each block's ``(o, lse)`` is merged
online (``_combine_packed``, with the JAX package's ``-inf`` guards).
The backward pass is the flash decomposition: every block's gradients
are recomputed from the GLOBAL lse and ``delta = sum_d(dO * O)``, dQ
accumulates locally, and the dK/dV accumulators travel with their K/V
and arrive home one hop after the last compute step.

- **Naive ring** (:func:`ring_attention`): contiguous shards; the
  diagonal block is causal; off it a block is full where its origin
  ``src < idx`` and skipped (lse ``-inf``, which the merge makes exact)
  otherwise, the K/V still forwarded. Non-causal rings see every block.
- **Zigzag ring** (:func:`ring_attention_zigzag`, causal only): the
  sequence cut into ``2n`` chunks, rank i holding chunks ``i`` and
  ``2n-1-i`` (:func:`to_zigzag`). A step whose origin j < i attends all
  local queries to the origin's head chunk (``2L x L``); j > i attends
  the local tail queries to both its chunks (``L x 2L``).

Every inner block is a call of the packed flash wrappers
(``ops.kernels.flash_attention_packed``): K-PACK forward, K-DQ and K-DKV
backward on CUDA, their plain versions on the CPU. The JAX package picks
an einsum inner block off the TPU and always uses it in its naive ring;
the port has no dense CUDA path, so both rings take the flash path the
TPU takes. ``BLOCKS`` counts the inner blocks by ``(kernel, Sq, Sk,
causal)``.

Tensors here are LOCAL shards: the ring functions take this rank's
``(B, S_local, H, D)`` (or packed ``(B, S_local, NH*D)``) slices and
return this rank's output, where the JAX functions take global arrays
under ``shard_map``.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from ..distributed import communication as comm
from .kernels.flash_attention_packed import (_delta, flash_attention_packed,
                                             packed_dkv, packed_dq,
                                             packed_fwd)

__all__ = ["ring_attention", "ring_attention_zigzag", "ring_attention_packed",
           "ring_attention_sharded", "zigzag_chunk_order", "to_zigzag",
           "from_zigzag", "BLOCKS"]

# the JAX package's masked-out logsumexp (its merge tests equality with it)
_NEG_INF = float(np.float32(-1e30))

# inner blocks run since the last clear: (kernel, Sq, Sk, causal) -> count
BLOCKS: collections.Counter = collections.Counter()


class _Ring:
    """One rank's place on a ring: the group, its size ``n``, this
    rank's index ``idx`` and its neighbours' global ranks."""

    def __init__(self, mesh, axis):
        self.group = mesh.group(axis)
        self.host_staged = mesh.host_staged
        self.n = mesh.shape[axis]
        self.idx = mesh.coords[axis]
        self.nxt = mesh.rank_at(**{axis: self.idx + 1})
        self.prv = mesh.rank_at(**{axis: self.idx - 1})

    def shift(self, *tensors):
        return comm.ring_shift(tensors, self.group, self.nxt, self.prv,
                               host_staged=self.host_staged)


def _blk_fwd(q, k, v, nh, scale, causal):
    BLOCKS["K-PACK", q.shape[1], k.shape[1], causal] += 1
    o, lse = packed_fwd(q, k, v, nh, causal=causal, scale=scale)
    return o.float(), lse


def _blk_dq(q, k, v, do, lse, delta, nh, scale, causal):
    BLOCKS["K-DQ", q.shape[1], k.shape[1], causal] += 1
    return packed_dq(q, k, v, do.to(q.dtype), lse.contiguous(),
                     delta.contiguous(), nh, causal=causal,
                     scale=scale).float()


def _blk_dkv(q, k, v, do, lse, delta, nh, scale, causal):
    BLOCKS["K-DKV", q.shape[1], k.shape[1], causal] += 1
    dk, dv = packed_dkv(q, k, v, do.to(q.dtype), lse.contiguous(),
                        delta.contiguous(), nh, causal=causal, scale=scale)
    return dk.float(), dv.float()


def _combine_packed(o_a, lse_a, o_b, lse_b, d):
    """Online-softmax merge in the packed layout: o ``(B, S, HP)`` fp32,
    lse ``(B, S, NH)`` fp32; per-head weights repeat over each head's d
    columns. Both ``-inf``: weights 0 and the lse stays ``-inf``."""
    lse_max = torch.maximum(lse_a, lse_b)
    lse_safe = torch.where(lse_max == _NEG_INF, 0.0, lse_max)
    w_a = torch.exp(lse_a - lse_safe)
    w_b = torch.exp(lse_b - lse_safe)
    denom = w_a + w_b
    safe = torch.where(denom == 0.0, 1.0, denom)
    lse = lse_max + torch.log(safe)
    o = (o_a * torch.repeat_interleave(w_a / safe, d, dim=-1)
         + o_b * torch.repeat_interleave(w_b / safe, d, dim=-1))
    return o, lse


# -- the naive ring ------------------------------------------------------------

def _naive_fwd(q, k, v, nh, scale, ring, causal):
    o, lse = _blk_fwd(q, k, v, nh, scale, causal)
    kt, vt = k, v
    for t in range(1, ring.n):
        kt, vt = ring.shift(kt, vt)
        if causal and (ring.idx - t) % ring.n > ring.idx:
            continue      # masked block: lse -inf, an exact no-op merge
        ob, lseb = _blk_fwd(q, kt, vt, nh, scale, False)
        o, lse = _combine_packed(o, lse, ob, lseb, q.shape[-1] // nh)
    return o, lse


def _naive_bwd(q, k, v, o, lse, do, nh, scale, ring, causal):
    delta = _delta(do, o, nh)
    dq = _blk_dq(q, k, v, do, lse, delta, nh, scale, causal)
    dk, dv = _blk_dkv(q, k, v, do, lse, delta, nh, scale, causal)
    kt, vt = k, v
    for t in range(1, ring.n):
        kt, vt, dk, dv = ring.shift(kt, vt, dk, dv)
        if causal and (ring.idx - t) % ring.n > ring.idx:
            continue
        dq = dq + _blk_dq(q, kt, vt, do, lse, delta, nh, scale, False)
        dkc, dvc = _blk_dkv(q, kt, vt, do, lse, delta, nh, scale, False)
        dk, dv = dk + dkc, dv + dvc
    dk, dv = ring.shift(dk, dv)        # the last hop brings them home
    return dq, dk, dv


# -- the zigzag ring -----------------------------------------------------------

def _zigzag_fwd(q, k, v, nh, scale, ring):
    """q, k, v: ``(B, 2L, HP)`` = [chunk i ; chunk 2n-1-i]. Returns
    ``(o fp32, lse)``."""
    b, s2, hp = q.shape
    L = s2 // 2
    d = hp // nh
    qa, qb = q[:, :L], q[:, L:]
    o_a, lse_a = _blk_fwd(qa, k[:, :L], v[:, :L], nh, scale, True)
    o_b1, lse_b1 = _blk_fwd(qb, k[:, :L], v[:, :L], nh, scale, False)
    o_b2, lse_b2 = _blk_fwd(qb, k[:, L:], v[:, L:], nh, scale, True)
    o_b, lse_b = _combine_packed(o_b1, lse_b1, o_b2, lse_b2, d)
    o = torch.cat([o_a, o_b], dim=1)
    lse = torch.cat([lse_a, lse_b], dim=1)
    kt, vt = k, v
    for t in range(1, ring.n):
        kt, vt = ring.shift(kt, vt)
        if (ring.idx - t) % ring.n < ring.idx:
            # step_lo: every local query sees the origin's head chunk
            ob, lseb = _blk_fwd(q, kt[:, :L], vt[:, :L], nh, scale, False)
        else:
            # step_hi: only the tail queries see the origin, both chunks
            ot, lset = _blk_fwd(qb, kt, vt, nh, scale, False)
            ob = torch.cat([torch.zeros_like(ot), ot], dim=1)
            lseb = torch.cat([torch.full_like(lset, _NEG_INF), lset], dim=1)
        o, lse = _combine_packed(o, lse, ob, lseb, d)
    return o, lse


def _zigzag_bwd(q, k, v, o, lse, do, nh, scale, ring):
    L = q.shape[1] // 2
    delta = _delta(do, o, nh)
    qa, qb = q[:, :L], q[:, L:]
    doa, dob = do[:, :L], do[:, L:]
    lse_a, lse_b = lse[:, :L], lse[:, L:]
    del_a, del_b = delta[:, :L], delta[:, L:]
    ka, kb = k[:, :L], k[:, L:]
    va, vb = v[:, :L], v[:, L:]
    dq_a = _blk_dq(qa, ka, va, doa, lse_a, del_a, nh, scale, True)
    dq_b = (_blk_dq(qb, ka, va, dob, lse_b, del_b, nh, scale, False)
            + _blk_dq(qb, kb, vb, dob, lse_b, del_b, nh, scale, True))
    dka1, dva1 = _blk_dkv(qa, ka, va, doa, lse_a, del_a, nh, scale, True)
    dka2, dva2 = _blk_dkv(qb, ka, va, dob, lse_b, del_b, nh, scale, False)
    dkb, dvb = _blk_dkv(qb, kb, vb, dob, lse_b, del_b, nh, scale, True)
    dq = torch.cat([dq_a, dq_b], dim=1)
    dk = torch.cat([dka1 + dka2, dkb], dim=1)
    dv = torch.cat([dva1 + dva2, dvb], dim=1)
    kt, vt = k, v
    for t in range(1, ring.n):
        kt, vt, dk, dv = ring.shift(kt, vt, dk, dv)
        if (ring.idx - t) % ring.n < ring.idx:
            ks, vs = kt[:, :L], vt[:, :L]
            dqc = _blk_dq(q, ks, vs, do, lse, delta, nh, scale, False)
            dkc, dvc = _blk_dkv(q, ks, vs, do, lse, delta, nh, scale, False)
            dq = dq + dqc
            dk = dk + torch.cat([dkc, torch.zeros_like(dkc)], dim=1)
            dv = dv + torch.cat([dvc, torch.zeros_like(dvc)], dim=1)
        else:
            dqc = _blk_dq(qb, kt, vt, dob, lse_b, del_b, nh, scale, False)
            dkc, dvc = _blk_dkv(qb, kt, vt, dob, lse_b, del_b, nh, scale,
                                False)
            dq = dq + torch.cat([torch.zeros_like(dqc), dqc], dim=1)
            dk, dv = dk + dkc, dv + dvc
    dk, dv = ring.shift(dk, dv)        # the last hop brings them home
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """A ring's forward (saving q, k, v, o and the global lse) and its
    flash-decomposition backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, nh, scale, ring, zigzag, causal):
        if zigzag:
            o, lse = _zigzag_fwd(q, k, v, nh, scale, ring)
        else:
            o, lse = _naive_fwd(q, k, v, nh, scale, ring, causal)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (nh, scale, ring, zigzag, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        nh, scale, ring, zigzag, causal = ctx.ring
        if zigzag:
            dq, dk, dv = _zigzag_bwd(q, k, v, o, lse, do, nh, scale, ring)
        else:
            dq, dk, dv = _naive_bwd(q, k, v, o, lse, do, nh, scale, ring,
                                    causal)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _scale(hp, nh, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(hp // nh)


def ring_attention_packed(q, k, v, nh, mesh, axis="sep", causal=True,
                          scale=None, zigzag=False):
    """The ring over this rank's packed ``(B, S_local, NH*D)`` shards:
    the zigzag ring (causal only) for shards already in zigzag order,
    else the naive ring. One rank on the axis is one causal (or full)
    flash attention."""
    if q.shape[-1] % nh:
        raise ValueError(f"width {q.shape[-1]} is not {nh} whole heads")
    scale = _scale(q.shape[-1], nh, scale)
    if zigzag and not causal:
        raise ValueError("zigzag layout is causal-only")
    if mesh.shape[axis] == 1:
        return flash_attention_packed(q, k, v, nh, causal=causal,
                                      scale=scale)
    if zigzag and q.shape[1] % 2:
        raise ValueError(f"zigzag shards hold two chunks; S_local "
                         f"{q.shape[1]} is odd")
    return _RingAttention.apply(q, k, v, nh, scale, _Ring(mesh, axis),
                                bool(zigzag), bool(causal))


def _packed(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def ring_attention(q, k, v, mesh, axis="sep", causal=True, scale=None):
    """The naive ring over this rank's contiguous ``(B, S_local, H, D)``
    shards (the global sequence is the shards in ring-index order).
    Returns this rank's output shard in q's dtype."""
    b, s, h, d = q.shape
    o = ring_attention_packed(_packed(q), _packed(k), _packed(v), h, mesh,
                              axis, causal, scale)
    return o.reshape(b, s, h, d)


def ring_attention_zigzag(q, k, v, mesh, axis="sep", scale=None):
    """The causal zigzag ring over this rank's ``(B, 2L, H, D)`` shard:
    chunks ``[ring index ; 2n-1-ring index]`` of the global sequence cut
    into ``2n`` (``to_zigzag`` of a globally ordered array)."""
    b, s, h, d = q.shape
    o = ring_attention_packed(_packed(q), _packed(k), _packed(v), h, mesh,
                              axis, True, scale, zigzag=True)
    return o.reshape(b, s, h, d)


def zigzag_chunk_order(n: int) -> np.ndarray:
    """Position p of the zigzag-ordered sequence holds global chunk
    ``zigzag_chunk_order(n)[p]`` (2n chunks; rank i gets positions 2i
    and 2i+1, global chunks i and 2n-1-i)."""
    order = np.empty(2 * n, np.int64)
    order[0::2] = np.arange(n)
    order[1::2] = 2 * n - 1 - np.arange(n)
    return order


def _take_chunks(x, n, axis, order):
    if isinstance(x, np.ndarray):
        axis = axis % x.ndim
        s = x.shape[axis]
        chunks = x.reshape(x.shape[:axis] + (2 * n, s // (2 * n))
                           + x.shape[axis + 1:])
        return np.take(chunks, order, axis=axis).reshape(x.shape)
    axis = axis % x.dim()
    s = x.shape[axis]
    chunks = x.reshape(tuple(x.shape[:axis]) + (2 * n, s // (2 * n))
                       + tuple(x.shape[axis + 1:]))
    idx = torch.as_tensor(order, device=x.device)
    return chunks.index_select(axis, idx).reshape(x.shape)


def to_zigzag(x, n: int, axis: int = 1):
    """A globally ordered tensor (or numpy array) reordered along
    ``axis`` into the zigzag layout; the length must divide by 2n."""
    return _take_chunks(x, n, axis, zigzag_chunk_order(n))


def from_zigzag(x, n: int, axis: int = 1):
    """The inverse of :func:`to_zigzag`."""
    return _take_chunks(x, n, axis, np.argsort(zigzag_chunk_order(n)))


def _reorder(x, mesh, axis, fn):
    """``fn`` (``to_zigzag`` / ``from_zigzag``) over the global sequence
    held in contiguous shards: all-gather along S, reorder, keep this
    rank's slice (autograd: the gather's backward reduce-scatters)."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    s = x.shape[1]
    full = comm.gather_dim(x, 1, mesh.group(axis))
    return fn(full, n, axis=1)[:, i * s:(i + 1) * s]


def ring_attention_sharded(q, k, v, mesh, seq_axis: str = "sep",
                           causal: bool = True, scale=None,
                           layout: str = "auto"):
    """Ring attention over this rank's ``(B, S_local, H, D)`` shards of
    the sequence along ``seq_axis`` (the batch and heads already split
    by the caller). ``layout``: ``"zigzag"`` (causal only: contiguous
    shards reordered into the zigzag layout at entry and back at exit,
    an all-gather over the axis each way), ``"zigzag_pre"`` (shards
    already zigzag, the trainer's end-to-end layout: no reorder),
    ``"naive"``, or ``"auto"`` (zigzag when causal and the global length
    divides by 2n, else naive). The inner block is always the packed
    flash kernels: the port has no einsum block."""
    n = mesh.shape[seq_axis]
    if layout == "auto":
        layout = ("zigzag" if causal and n > 1
                  and (q.shape[1] * n) % (2 * n) == 0
                  and q.shape[1] == k.shape[1] else "naive")
    if layout not in ("zigzag", "zigzag_pre", "naive"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "naive":
        return ring_attention(q, k, v, mesh, seq_axis, causal, scale)
    if not causal:
        raise ValueError("zigzag layout is causal-only")
    if layout == "zigzag_pre" or n == 1:
        return ring_attention_zigzag(q, k, v, mesh, seq_axis, scale)
    qz, kz, vz = (_reorder(x, mesh, seq_axis, to_zigzag) for x in (q, k, v))
    o = ring_attention_zigzag(qz, kz, vz, mesh, seq_axis, scale)
    return _reorder(o, mesh, seq_axis, from_zigzag)
