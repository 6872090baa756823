"""Attention dispatch (port of ``paddle_tpu.ops.attention_dispatch``).

The rule is the device, and only the device: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel, which raises on a shape it does not take. There is no fallback
from a CUDA tensor to a plain version and no shape gate that routes one
there.
"""
from __future__ import annotations

import torch

from .kernels.flash_attention import attention_bshd
from .kernels.flash_attention_packed import (flash_attention_packed,
                                             flash_attention_packed_seg)
from .kernels import flash_attention_packed as _fp
from .kernels import paged_attention as _paged

__all__ = ["paged_attention", "paged_multiquery_attention",
           "segment_attention_packed", "dense_segment_attention",
           "causal_attention", "causal_attention_packed", "ring_is_zigzag"]


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None,
                    scales=None):
    """One decode step of paged attention (serving): ``q`` (B, nh, d)
    against the pool pages ``(P, page_size, nh_kv*d)`` through
    ``page_table`` (B, max_pages) with ``seq_lens`` (B,); a seq_len-0
    padding row outputs zeros. ``scales`` (P, 2, nh_kv) fp32 marks int8
    pools. K-DEC (K-DEC8) on CUDA. Unlike the JAX dispatch there is no
    tiling gate: the kernels take any page size."""
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_table,
                                         seq_lens, scale=scale,
                                         scales=scales)


def paged_multiquery_attention(q, k_pages, v_pages, page_table, seq_lens,
                               scale=None, scales=None):
    """Speculative-decoding verify attention: ``q`` (B, qlen, nh, d), the
    window's K/V already written at positions ``seq_lens - qlen ..
    seq_lens - 1``, causal within the window, over the same pools as
    :func:`paged_attention` (``scales`` for int8). K-MQ (K-MQ8) on
    CUDA."""
    return _paged.paged_multiquery_attention(q, k_pages, v_pages,
                                             page_table, seq_lens,
                                             scale=scale, scales=scales)


def dense_segment_attention(q, k, v, nh, seg_q, seg_k, scale=None,
                            dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch causal attention with distinct key-side ids over the
    packed ``(B, S, NH*D)`` layout (``xla_segment_attention``'s causal
    case), one dense fp32 softmax: query i attends key j only where
    ``seg_q[i] == seg_k[j]`` and, bottom-right aligned per sequence,
    ``jk <= iq + Lk - Lq`` (``iq`` and ``jk`` their local indices in a
    sequence of ``Lq`` queries and ``Lk`` keys). A row that sees no key
    outputs 0. ``dropout_p`` drops the masked probabilities by ``keep``
    (the tests' bits) or the Philox bits of ``rng``. Taken on the CPU
    only: no kernel computes this case, and
    :func:`segment_attention_packed` raises on CUDA."""
    logits, ok = _fp._scores(q, k, nh, False, _fp._scale_of(q, nh, scale),
                             seg_q, seg_k)             # ok (B, 1, Sq, Sk)
    seg_q, seg_k = seg_q.long(), seg_k.long()
    iq = torch.arange(q.shape[1], device=q.device)
    ik = torch.arange(k.shape[1], device=q.device)
    eq_qq = seg_q[:, :, None] == seg_q[:, None, :]
    eq_kk = seg_k[:, :, None] == seg_k[:, None, :]
    pos_q = (eq_qq & (iq[None, None, :] < iq[None, :, None])).sum(-1)
    pos_k = (eq_kk & (ik[None, None, :] < ik[None, :, None])).sum(-1)
    bound = pos_q + ok[:, 0].sum(-1) - eq_qq.sum(-1)       # (B, Sq)
    ok = ok & (pos_k[:, None, :] <= bound[:, :, None])[:, None]
    p = torch.softmax(logits.masked_fill(~ok, _fp._NEG_INF), dim=-1)
    p = p.masked_fill(~ok, 0.0)
    p = _fp._dropped(p, _fp.keep_of(keep, dropout_p, rng, logits.shape,
                                    q.device), dropout_p)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), _fp._unpack(v, nh))
    return o.reshape(q.shape)


def segment_attention_packed(q, k, v, nh, seg_q, seg_k=None, causal=True,
                             scale=None, dropout_p=0.0, rng=None):
    """Differentiable segment-masked attention over the packed
    ``(B, S, NH*D)`` layout, causal or not: query i attends key j only
    where ``seg_q[i] == seg_k[j]`` (``seg_k`` None: the query ids). K-SEG
    forward, K-SDQ and K-SDKV backward on CUDA (serving's
    ``prefill_packed``, ``nn.functional``'s segmented and varlen
    attention, BERT's padded batches). Causal attention with distinct
    key-side ids has no kernel (its causality is aligned per sequence):
    the CPU takes :func:`dense_segment_attention`, CUDA raises.
    ``dropout_p`` drops the probabilities with the Philox bits of ``rng``
    (default: a key from ``framework.random.next_rng_key``), K-SEG,
    K-SDQ and K-SDKV's DROP variants on CUDA."""
    if causal and seg_k is not None:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "segment_attention_packed: causal attention with distinct "
                "key-side segment ids is not ported to the GPU "
                "(ROADMAP.md B.2); the JAX package runs it dense")
        if dropout_p and rng is None:
            from ..framework.random import next_rng_key

            rng = next_rng_key()
        return dense_segment_attention(q, k, v, nh, seg_q, seg_k,
                                       scale=scale, dropout_p=dropout_p,
                                       rng=rng)
    return flash_attention_packed_seg(q, k, v, seg_q, nh, scale=scale,
                                      segment_ids_k=seg_k, causal=causal,
                                      dropout_p=dropout_p, rng=rng)


def causal_attention(q, k, v, scale=None, dropout_p=0.0, rng=None):
    """Differentiable ``(B, S, H, D)`` causal attention (``prefill_batch``
    and the no-cache forward): K-BSHD forward, K-BDQ and K-BDKV backward
    on CUDA, their DROP variants with ``dropout_p`` (``rng`` default: a
    key from ``framework.random.next_rng_key``). q, k, v may be the
    ``unbind`` views of the fused qkv. Ring attention is not ported."""
    return attention_bshd(q, k, v, causal=True, scale=scale,
                          dropout_p=dropout_p, rng=rng)


def ring_is_zigzag(ring) -> bool:
    """True when a ring spec is the end-to-end zigzag form
    ``(mesh, axis, "zigzag")``: the data already permuted by the
    trainer."""
    return ring is not None and len(ring) > 2 and ring[2] == "zigzag"


def causal_attention_packed(q, k, v, nh, scale=None, ring=None,
                            segment_ids=None):
    """Differentiable causal attention over the packed ``(B, S, NH*D)``
    layout, the training path (``transformer_core.gpt_block``): K-PACK
    forward, K-DQ and K-DKV backward on CUDA; with ``segment_ids``
    ``(B, S)`` (the packed-sequence trainer) K-SEG forward, K-SDQ and
    K-SDKV backward. q, k, v may be column slices of the fused qkv
    projection. ``ring=(mesh, axis)`` or ``(mesh, axis, "zigzag")``:
    q, k, v are this rank's sequence shards and attention runs as ring
    attention over the mesh axis (``ops.ring_attention``): the zigzag
    ring for the end-to-end zigzag layout, else the naive ring, every
    block K-PACK, K-DQ and K-DKV on CUDA."""
    if segment_ids is not None and ring is not None:
        raise ValueError(
            "segment_ids and ring attention cannot combine: the ring "
            "shards the sequence across ranks, the packed mask is "
            "per-token; run packed batches with sep=1")
    if ring is not None:
        from .ring_attention import ring_attention_packed

        # (mesh, axis, "zigzag"): the trainer keeps the whole sequence in
        # zigzag order end to end, so no per-call reorders
        return ring_attention_packed(q, k, v, nh, ring[0], ring[1],
                                     causal=True, scale=scale,
                                     zigzag=ring_is_zigzag(ring))
    if segment_ids is not None:
        return flash_attention_packed_seg(q, k, v, segment_ids, nh,
                                          scale=scale)
    return flash_attention_packed(q, k, v, nh, causal=True, scale=scale)
