"""Attention functionals (port of ``paddle_tpu.nn.functional.attention``).

Plain functions on torch tensors with the JAX package's signatures and
return conventions, over the port's flash kernels:

- ``scaled_dot_product_attention``: K-BSHD forward, K-BDQ and K-BDKV
  backward (``ops.kernels.flash_attention.attention_bshd``), causal or
  full; an ``attn_mask`` is added to the scores inside the kernels (their
  BIAS variants, the mask broadcast to ``(B, H, Sq, Sk)`` by strides, no
  gradient), a bool mask as 1.0 / 0.0 (the JAX package's
  ``qt + mask.astype(qt.dtype)``); rectangular causal attention
  (``Sq != Sk``, aligned to the end) is an end-aligned -1e30 bias built in
  the call;
- ``flash_attention(..., segment_ids=...)`` and ``flash_attn_unpadded``
  (varlen attention over ``cu_seqlens``): K-SEG forward, K-SDQ and K-SDKV
  backward (``ops.attention_dispatch.segment_attention_packed``), full
  attention with distinct key-side ids and ``Sq != Sk`` included.

Active attention dropout (``dropout_p > 0`` and ``training``) runs the
same kernels' DROP variants with a key from
``framework.random.next_rng_key()``, where the JAX package draws its
key; the keep bits are Philox's (``ops.kernels.philox``), so the two
packages drop different entries at the same rate. Varlen causal attention
with distinct ``cu_seqlens`` has no kernel: its plain version
(``ops.attention_dispatch.dense_segment_attention``) on the CPU, a raise
on CUDA. ``return_softmax=True`` raises as in the JAX package (the
kernels never form the softmax matrix). ``_sdpa_ref`` is the JAX
package's dense function in plain PyTorch, the tests' oracle.
"""
from __future__ import annotations

import math

import torch

from ...framework.random import next_rng_key
from ...ops.attention_dispatch import segment_attention_packed
from ...ops.kernels.flash_attention import attention_bshd
from ...ops.kernels.flash_attention_packed import (_dropped,
                                                   cu_seqlens_to_segment_ids,
                                                   keep_of)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sequence_mask"]


def _active(p, training) -> float:
    return float(p) if training and p > 0.0 else 0.0


def _sdpa_ref(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0,
              rng=None, keep=None):
    """Plain PyTorch dense attention over ``(B, S, H, D)`` (mirrors the
    JAX package's ``_sdpa_ref``): an fp32 softmax of ``scale * q.k`` plus
    ``mask``, causal end-aligned when ``Sk > Sq`` (query i sits at
    position ``Sk - Sq + i``), the probabilities dropped by ``keep`` (the
    tests' bits, ``(B, H, Sq, Sk)``) or the Philox bits of ``rng``."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qt = torch.einsum("bshd,bthd->bhst", q, k) * s
    if causal:
        sq, sk = qt.shape[-2], qt.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        qt = qt.masked_fill(~cm, -1e30)
    if mask is not None:
        qt = qt + mask.to(qt.dtype)
    p = torch.softmax(qt.float(), dim=-1).to(q.dtype)
    p = _dropped(p, keep_of(keep, dropout_p, rng, p.shape, q.device),
                 dropout_p)
    return torch.einsum("bhst,bthd->bshd", p, v)


def _end_aligned_causal_bias(sq, sk, device):
    """``(Sq, Sk)`` fp32: 0 where key j <= query i's position ``Sk - Sq +
    i``, -1e30 elsewhere (the JAX package's rectangular causal mask)."""
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq)
    return torch.zeros(sq, sk, device=device).masked_fill(~ok, -1e30)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` over the
    ``(B, S, H, D)`` layout: K-BSHD (K-BDQ, K-BDKV in the backward),
    causal (``Sq == Sk``) or full (any ``Sk``); the CPU takes the
    kernels' plain versions. ``attn_mask`` (additive, broadcast to
    ``(B, H, Sq, Sk)``; bool adds 1.0 where true) takes the kernels'
    BIAS variants, and so does rectangular causal attention, as an
    end-aligned bias; active dropout their DROP variants."""
    q, k, v = query, key, value
    p = _active(dropout_p, training)
    bias, causal = attn_mask, is_causal
    if is_causal and q.shape[1] != k.shape[1]:
        bias = _end_aligned_causal_bias(q.shape[1], k.shape[1], q.device)
        if attn_mask is not None:
            bias = bias + attn_mask.to(bias.dtype)
        causal = False
    return attention_bshd(q, k, v, causal=causal, bias=bias, dropout_p=p,
                          rng=next_rng_key() if p else None)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, segment_ids=None,
                    segment_ids_k=None):
    """``paddle.nn.functional.flash_attention.flash_attention`` parity:
    returns ``(out, None)``. ``segment_ids`` ``(B, Sq)`` (the JAX
    package's extension) masks attention across segments through K-SEG,
    causal or not; ``segment_ids_k`` ``(B, Sk)`` (the port's extension,
    the varlen contract's key-side ids; ``causal=False`` only on CUDA)
    gives the keys ids of their own, as BERT's padding mask does (query
    ids 0, key ids 0 on real tokens and -1 on pads)."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attention(return_softmax=True) is not supported: the "
            "flash kernels never materialize the softmax matrix")
    if segment_ids is None:
        if segment_ids_k is not None:
            raise ValueError("flash_attention: segment_ids_k needs "
                             "segment_ids")
        return scaled_dot_product_attention(query, key, value, None, 0.0,
                                            causal, training), None
    b, s, h, d = query.shape
    o = segment_attention_packed(
        query.flatten(2), key.flatten(2), value.flatten(2), h, segment_ids,
        segment_ids_k, causal=causal, dropout_p=_active(dropout, training))
    return o.reshape(b, s, h, d), None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (unpadded) attention, the reference's
    ``flash_attn_unpadded`` contract: ``query`` ``(total_q, nh, d)`` and
    ``key``, ``value`` ``(total_k, nh, d)`` packed over sequences that
    ``cu_seqlens_q`` / ``cu_seqlens_k`` (int ``(nseq + 1,)``, ``cu[0] ==
    0``) delimit; no token attends across a sequence, and tokens past
    ``cu[-1]`` are pads (id -1). Returns ``(out, None)``, out
    ``(total_q, nh, d)``. The same ``cu_seqlens`` on both sides with
    ``total_q == total_k`` is self-attention (one id array, causal or
    not); otherwise the keys carry ids of their own: K-SEG (K-SDQ,
    K-SDKV) with ``causal=False``, and ``dense_segment_attention`` on the
    CPU (CUDA raises) with ``causal=True``."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True) is not supported: "
            "the flash kernels never materialize the softmax matrix")
    if int(max_seqlen_q) <= 0 or int(max_seqlen_k) <= 0:
        raise ValueError("max_seqlen_q/max_seqlen_k must be positive")
    tq, nh, d = query.shape
    tk = key.shape[0]
    cu_q = torch.as_tensor(cu_seqlens_q, device=query.device)
    cu_k = torch.as_tensor(cu_seqlens_k, device=query.device)
    same_cu = cu_seqlens_q is cu_seqlens_k or (
        cu_q.shape == cu_k.shape and bool(torch.equal(cu_q, cu_k)))
    seg_q = cu_seqlens_to_segment_ids(cu_q, tq)[None]     # (1, total_q)
    # None key-side ids: self-attention, the causal triangle exact
    seg_k = (None if same_cu and tq == tk
             else cu_seqlens_to_segment_ids(cu_k, tk)[None])
    o = segment_attention_packed(
        query.reshape(1, tq, nh * d), key.reshape(1, tk, nh * d),
        value.reshape(1, tk, nh * d), nh, seg_q, seg_k, causal=causal,
        scale=scale, dropout_p=_active(dropout, training))
    return o.reshape(tq, nh, d), None


# every dtype name the JAX package's ``framework.dtype`` knows
_DTYPES = {name: getattr(torch, name) for name in (
    "float16", "bfloat16", "float32", "float64", "int8", "int16", "int32",
    "int64", "uint8", "bool", "complex64", "complex128", "float8_e4m3fn",
    "float8_e5m2")}
_DTYPES["bool_"] = torch.bool


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``out[..., j] = j < x[...]`` of width ``maxlen`` (default
    ``max(x)``), exactly 0 or 1 in ``dtype`` (a name the JAX package
    knows, or a torch dtype)."""
    x = torch.as_tensor(x)
    ml = int(x.max()) if maxlen is None else int(maxlen)
    dt = _DTYPES[dtype.lower()] if isinstance(dtype, str) else dtype
    r = torch.arange(ml, device=x.device)
    return (r < x[..., None]).to(dt)
