"""Flash attention over the ``(B, S, H, D)`` layout: three kernels.

Each replaces a Pallas TPU kernel of
``paddle_tpu/ops/pallas/flash_attention.py``:

=======  ==========================  ========================================
kernel   wrapper                     replaces (launched by)
=======  ==========================  ========================================
K-BSHD   ``bshd_fwd``                ``_fwd_kernel`` (``_flash_call``)
         (``flash_attention_bshd``)
K-BDQ    ``bshd_dq``                 ``_dq_kernel`` (``_flash_bwd_call``)
K-BDKV   ``bshd_dkv``                ``_dkv_kernel`` (``_flash_bwd_call``)
=======  ==========================  ========================================

The three together are ``FlashAttentionBSHD`` (``attention_bshd``), the
attention of the model's no-cache forward: serving's ``prefill_batch``
(``generate()``, no gradient: K-BSHD alone) and the nn-API training path
(``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` -> ``backward()``),
causal; and ``nn.functional``'s ``scaled_dot_product_attention``, full
(``causal=False``: BERT's unpadded batches, the transformer layers) or
causal, with an additive mask (``bias``, the BIAS variants: BERT's 4-D
mask, ``MultiHeadAttention``'s masks, rectangular causal attention) and
attention dropout (``dropout_p`` with ``rng``, the DROP variants; see
``flash_attention_packed``).
A ``(B, S, H, D)`` tensor whose last two dims are dense has the bytes of
``(B, S, H*D)`` with a row stride, so the kernels are the packed
layout's: K-BSHD launches K-PACK's strided entry
(``flash_attention_fwd_packed`` of ``paddle_tpu_torch/csrc/
flash_attention_fwd.cu``, kernels in ``flash_fwd.cuh``), K-BDQ and
K-BDKV launch K-DQ's and K-DKV's (``csrc/flash_attention_bwd.cu``,
kernels in ``flash_bwd.cuh``); with a mask or dropout, the entries of
the BIAS and DROP variants (``csrc/flash_attention_fwd_ext.cu``,
``flash_attention_bwd_{dq,dkv}_ext.cu``). The TPU's ``(B*H, S, D)`` transpose
is gone, and q, k, v may be the views that ``unbind`` makes of the fused
qkv projection: they are read in place.

Layouts: q, k, v, o and the gradients ``(B, S, H, D)``; ``lse`` (the
forward's natural-log row normaliser) and ``delta`` ``(B, S, H)`` fp32.
The kernels' causal mask is top-left with ``Sq == Sk``; full attention
takes ``Sq != Sk``.

What bounds them on the H100: ~4*d (forward), ~6*d (dQ) and ~8*d (dK/dV)
FLOPs per visible (query, key) pair, operations rather than bytes. In
bf16 the forward and both backward kernels run every product on the
tensor cores (wgmma, tiles brought in by TMA); in fp32 the kernels run
them on the CUDA cores from 64x64 shared-memory tiles. No kernel visits
tiles above the diagonal (see K-PACK's note).

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import flash_attention_packed as fp

__all__ = ["flash_attention_bshd", "causal_attention_ref", "bshd_dq_ref",
           "bshd_dkv_ref", "bshd_fwd", "bshd_dq", "bshd_dkv",
           "FlashAttentionBSHD", "attention_bshd"]

# kernel launches since the last reset (each wrapper adds one to its
# kernel's count per launch)
LAUNCHES = {"K-BSHD": 0, "K-BDQ": 0, "K-BDKV": 0}
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_attention_ref(q, k, v, causal=True, scale=None, bias=None,
                         dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch version (mirrors ``xla_causal_attention``): one
    dense fp32 softmax over ``(B, S, H, D)``, the causal mask aligned to
    the end (``Sk > Sq`` reads as a cache); ``bias`` (broadcast to
    ``(B, H, Sq, Sk)``, floored at ``BIAS_FLOOR``) added to the scores,
    and ``dropout_p`` dropping the probabilities by ``keep`` or the
    Philox bits of ``rng``. Returns ``(o, lse)``, lse undropped."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = (q * scale).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if bias is not None:
        logits = logits + bias.float().clamp(min=fp.BIAS_FLOOR)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(idx_k <= idx_q), _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, H, Sq)
    p = torch.softmax(logits, dim=-1)
    p = fp._dropped(p, fp.keep_of(keep, dropout_p, rng, logits.shape,
                                  q.device), dropout_p)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, lse.transpose(1, 2).contiguous()


def _flat(*ts):
    """``(B, S, H, D)`` -> ``(B, S, H*D)``: a view when the last two dims
    are dense (a row-strided slice stays one), else a copy."""
    return tuple(t.flatten(2) for t in ts)


def bshd_dq_ref(q, k, v, do, lse, delta, causal=True, scale=None,
                bias=None, dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch K-BDQ (mirrors ``_dq_kernel`` of ``_flash_bwd_call``
    over ``(B, S, H, D)``): ``dq = scale * ds.k``, ``ds = p * (do.v -
    delta)``, ``p = exp(scale * q.k - lse)``; ``lse``, ``delta``
    ``(B, S, H)``; ``bias``, ``dropout_p``, ``rng``, ``keep`` the
    forward's. Returns dq in q's dtype."""
    h = q.shape[2]
    return fp.packed_dq_ref(*_flat(q, k, v, do), lse, delta, h,
                            causal=causal, scale=scale, bias=bias,
                            dropout_p=dropout_p, rng=rng,
                            keep=keep).view(q.shape)


def bshd_dkv_ref(q, k, v, do, lse, delta, causal=True, scale=None,
                 bias=None, dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch K-BDKV (mirrors ``_dkv_kernel``): ``dk = scale *
    ds^T.q``, ``dv = p^T.do``. Returns ``(dk, dv)`` in q's dtype."""
    h = q.shape[2]
    dk, dv = fp.packed_dkv_ref(*_flat(q, k, v, do), lse, delta, h,
                               causal=causal, scale=scale, bias=bias,
                               dropout_p=dropout_p, rng=rng, keep=keep)
    return dk.view(k.shape), dv.view(v.shape)


def _same_shape(what, q, k, v, causal):
    """q ``(B, Sq, H, D)`` and k, v ``(B, Sk, H, D)``; causal attention
    (top-left) needs ``Sq == Sk``."""
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or (q.shape[0], *q.shape[2:]) != (k.shape[0], *k.shape[2:])
            or (causal and q.shape[1] != k.shape[1])):
        raise ValueError(f"{what}: q (B, Sq, H, D) and k, v (B, Sk, H, D) "
                         "expected, Sq == Sk when causal (the mask is "
                         "top-left)")


def _bias(bias, q, k):
    return None if bias is None else fp.bias_view(
        bias, q.shape[0], q.shape[2], q.shape[1], k.shape[1])


def bshd_fwd(q, k, v, causal=True, scale=None, bias=None, dropout_p=0.0,
             rng=None):
    """Attention over ``(B, S, H, D)`` whose q, k, v may be row-strided
    views (the fused qkv's ``unbind``): the plain version for CPU
    tensors, K-BSHD for CUDA tensors. ``bias`` (an additive mask that
    broadcasts to ``(B, H, Sq, Sk)``) and ``dropout_p`` with ``rng =
    (seed, offset)`` take the kernel's BIAS and DROP variants. Returns
    ``(o, lse)``."""
    bias = _bias(bias, q, k)
    if q.device.type == "cpu":
        return causal_attention_ref(q, k, v, causal=causal, scale=scale,
                                    bias=bias, dropout_p=dropout_p, rng=rng)
    _same_shape("bshd_fwd", q, k, v, causal)
    o, lse = fp._launch_fwd("bshd_fwd", *_flat(q, k, v), q.shape[2],
                            causal, scale, bias=bias, dropout_p=dropout_p,
                            rng=rng)
    fp._count(LAUNCHES, "K-BSHD", bias, dropout_p)
    return o.view(q.shape), lse


# the JAX package's name for the forward
flash_attention_bshd = bshd_fwd


def bshd_dq(q, k, v, do, lse, delta, causal=True, scale=None, bias=None,
            dropout_p=0.0, rng=None):
    """dQ over ``(B, S, H, D)`` from the forward's lse and delta (and its
    ``bias``, ``dropout_p``, ``rng``): the plain version for CPU tensors,
    K-BDQ for CUDA tensors."""
    bias = _bias(bias, q, k)
    if q.device.type == "cpu":
        return bshd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                           scale=scale, bias=bias, dropout_p=dropout_p,
                           rng=rng)
    _same_shape("bshd_dq", q, k, v, causal)
    dq = fp._launch_bwd("bshd_dq", "dq", *_flat(q, k, v, do), lse, delta,
                        q.shape[2], causal, scale, bias=bias,
                        dropout_p=dropout_p, rng=rng)
    fp._count(LAUNCHES, "K-BDQ", bias, dropout_p)
    return dq.view(q.shape)


def bshd_dkv(q, k, v, do, lse, delta, causal=True, scale=None, bias=None,
             dropout_p=0.0, rng=None):
    """dK, dV over ``(B, S, H, D)``: the plain version for CPU tensors,
    K-BDKV for CUDA tensors. Returns ``(dk, dv)``."""
    bias = _bias(bias, q, k)
    if q.device.type == "cpu":
        return bshd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                            scale=scale, bias=bias, dropout_p=dropout_p,
                            rng=rng)
    _same_shape("bshd_dkv", q, k, v, causal)
    dk, dv = fp._launch_bwd("bshd_dkv", "dkv", *_flat(q, k, v, do), lse,
                            delta, q.shape[2], causal, scale, bias=bias,
                            dropout_p=dropout_p, rng=rng)
    fp._count(LAUNCHES, "K-BDKV", bias, dropout_p)
    return dk.view(k.shape), dv.view(v.shape)


class FlashAttentionBSHD(torch.autograd.Function):
    """Flash attention over ``(B, S, H, D)`` with its backward (mirrors
    the JAX package's ``_flash_attention`` custom_vjp): the forward runs
    K-BSHD and saves ``(q, k, v, o, lse)``, the mask and the dropout key;
    the backward computes ``delta = sum_d(do * o)`` (the dropped output)
    in fp32 and runs K-BDQ and K-BDKV, which regenerate the forward's
    keep bits. The mask takes no gradient. On CPU tensors each step is its
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bias, dropout_p, rng):
        o, lse = bshd_fwd(q, k, v, causal=causal, scale=scale, bias=bias,
                          dropout_p=dropout_p, rng=rng)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.attn = dict(causal=causal, scale=scale, dropout_p=dropout_p,
                        rng=rng)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1)            # (B, S, H)
        dq = bshd_dq(q, k, v, do, lse, delta, bias=bias, **ctx.attn)
        dk, dv = bshd_dkv(q, k, v, do, lse, delta, bias=bias, **ctx.attn)
        return dq, dk, dv, None, None, None, None, None


def attention_bshd(q, k, v, causal=True, scale=None, bias=None,
                   dropout_p=0.0, rng=None):
    """Differentiable flash attention over ``(B, S, H, D)`` (the JAX
    package's ``flash_attention_bshd``, any S): returns ``o``. ``bias``
    is an additive mask: the kernels give it no gradient (one with
    ``requires_grad`` raises off the CPU; on the CPU autograd runs
    through the plain version, as the JAX package differentiates
    ``_sdpa_ref``); ``dropout_p`` drops the probabilities with the
    Philox bits of ``rng`` (default: a key from
    ``framework.random.next_rng_key``)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    dropout_p = float(dropout_p)
    if dropout_p and rng is None:
        from ...framework.random import next_rng_key

        rng = next_rng_key()
    if bias is not None and bias.requires_grad:
        if q.device.type != "cpu" or bias.device.type != "cpu":
            raise ValueError("attention_bshd: the kernels give the "
                             "attention mask no gradient; pass it detached")
        return bshd_fwd(q, k, v, causal=causal, scale=scale, bias=bias,
                        dropout_p=dropout_p,
                        rng=rng if dropout_p else None)[0]
    return FlashAttentionBSHD.apply(q, k, v, causal, scale, bias, dropout_p,
                                    rng if dropout_p else None)
