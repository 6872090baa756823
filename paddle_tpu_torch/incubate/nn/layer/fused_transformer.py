"""Fused transformer layers (port of
``paddle_tpu.incubate.nn.layer.fused_transformer``):
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer`` and ``FusedMultiTransformer``.

The JAX package keeps the reference's API (the packed qkv weight, pre- or
post-LayerNorm, residual and dropout placement) and leaves the fusion to
XLA; the port does the same with PyTorch operators around the flash
kernels. Attention is ``nn.functional.scaled_dot_product_attention`` on
the ``unbind`` views of the packed qkv projection (read in place by the
kernels): K-BSHD forward, K-BDQ and K-BDKV backward on CUDA, causal when
the layer is ``causal`` and no mask is given (``is_causal=causal and
attn_mask is None``, as the JAX package routes it), a mask added inside
the kernels (BIAS) and attention dropout in them (DROP) in training.
Self-attention only: ``key`` and ``value`` are not read, as in the JAX
package.

Parameter names are the JAX package's; the weights are stored in
PyTorch's ``(out, in)`` layout (``qkv_weight`` ``(3E, E)``,
``linear_weight`` ``(E, E)``, ``linear1_weight`` ``(F, E)``,
``linear2_weight`` ``(E, F)``), so
``utils.convert.from_fused_transformer_state`` transposes Paddle's
``(in, out)`` ones. Weights are drawn Xavier-uniform (the JAX layers'
initializer) from PyTorch's RNG, biases zero, LayerNorm scales one. Each
layer takes ``device`` (None: the card) and ``dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....nn import functional as NF

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer"]


def _weight(out_f, in_f, kw) -> nn.Parameter:
    w = torch.empty(out_f, in_f, **kw)
    nn.init.xavier_uniform_(w)
    return nn.Parameter(w)


def _const(n, value, kw) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), float(value), **kw))


class FusedMultiHeadAttention(nn.Module):
    """Attention with the packed qkv weight, pre- or post-LayerNorm, the
    residual add and dropout."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, causal=False, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not {num_heads} "
                             "whole heads")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.causal = causal
        self._epsilon = epsilon
        self.qkv_weight = _weight(3 * embed_dim, embed_dim, kw)
        self.qkv_bias = _const(3 * embed_dim, 0.0, kw)
        self.linear_weight = _weight(embed_dim, embed_dim, kw)
        self.linear_bias = _const(embed_dim, 0.0, kw)
        self.pre_ln_scale = _const(embed_dim, 1.0, kw)
        self.pre_ln_bias = _const(embed_dim, 0.0, kw)
        self.ln_scale = _const(embed_dim, 1.0, kw)
        self.ln_bias = _const(embed_dim, 0.0, kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        residual = x = query
        e = self.embed_dim
        if self.normalize_before:
            x = F.layer_norm(x, (e,), self.pre_ln_scale, self.pre_ln_bias,
                             self._epsilon)
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias)
        b, s, _ = qkv.shape
        q, k, v = qkv.view(b, s, 3, self.num_heads, self.head_dim).unbind(2)
        out = NF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate if self.training else 0.0,
            is_causal=self.causal and attn_mask is None)
        out = F.linear(out.reshape(b, s, e), self.linear_weight,
                       self.linear_bias)
        out = residual + F.dropout(out, self.dropout_rate, self.training)
        if not self.normalize_before:
            out = F.layer_norm(out, (e,), self.ln_scale, self.ln_bias,
                               self._epsilon)
        return out


class FusedFeedForward(nn.Module):
    """The feed-forward block: pre- or post-LayerNorm, two linears with
    the activation and its dropout between them, the residual add."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self._epsilon = epsilon
        self.linear1_weight = _weight(dim_feedforward, d_model, kw)
        self.linear1_bias = _const(dim_feedforward, 0.0, kw)
        self.linear2_weight = _weight(d_model, dim_feedforward, kw)
        self.linear2_bias = _const(d_model, 0.0, kw)
        self.ln1_scale = _const(d_model, 1.0, kw)
        self.ln1_bias = _const(d_model, 0.0, kw)
        self.ln2_scale = _const(d_model, 1.0, kw)
        self.ln2_bias = _const(d_model, 0.0, kw)

    def forward(self, src, cache=None):
        residual = x = src
        d = (self.d_model,)
        if self.normalize_before:
            x = F.layer_norm(x, d, self.ln1_scale, self.ln1_bias,
                             self._epsilon)
        x = getattr(F, self.activation)(
            F.linear(x, self.linear1_weight, self.linear1_bias))
        x = F.dropout(x, self.act_dropout_rate, self.training)
        x = F.linear(x, self.linear2_weight, self.linear2_bias)
        out = residual + F.dropout(x, self.dropout_rate, self.training)
        if not self.normalize_before:
            out = F.layer_norm(out, d, self.ln2_scale, self.ln2_bias,
                               self._epsilon)
        return out


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, causal=False,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, causal=causal, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """``num_layers`` stacked fused layers in one call, causal by default
    (decoder semantics; ``causal=False`` for a bidirectional stack), the
    layers registered as ``layer_0``, ``layer_1``, ... and listed in
    ``layers``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, causal=True, device=None,
                 dtype=torch.float32, **kw):
        super().__init__()
        dev = resolve_device(device)
        self.layers = [
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before, causal=causal,
                device=dev, dtype=dtype)
            for _ in range(num_layers)]
        for i, layer in enumerate(self.layers):
            setattr(self, f"layer_{i}", layer)

    def forward(self, src, attn_mask=None, caches=None, **kw):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x
