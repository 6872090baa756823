"""Transformer layers (port of ``paddle_tpu.nn.layer.transformer``):
``MultiHeadAttention`` with its ``Cache`` and ``StaticCache``, the
encoder and decoder layers and stacks, and ``Transformer`` with
``generate_square_subsequent_mask``.

The classes, their arguments and their parameters' names are the JAX
package's, so ``utils.convert.from_transformer_state`` carries a
``state_dict`` across (Paddle's ``(in, out)`` linear weights transposed
to ``nn.Linear``'s ``(out, in)``). Attention runs through
``nn.functional.scaled_dot_product_attention``, as in the JAX package:
K-BSHD forward, K-BDQ and K-BDKV backward on CUDA, every mask (the
causal ``generate_square_subsequent_mask``, padding masks, a cross
attention's ``memory_mask``) added inside the kernels (their BIAS
variants, no gradient on CUDA) and attention dropout in them (their DROP
variants, Philox keys from ``framework.random``). A query over a cache
(``Sq != Sk``) is full attention over every cached key, as in the JAX
package when no mask is given.

Each layer takes ``device`` (None: the card, raising without one;
``"cpu"`` runs the plain versions) and ``dtype``. Linear weights are
drawn Xavier-normal with zero biases (Paddle's default) from PyTorch's
RNG; ``weight_attr`` is not read, and ``bias_attr=False`` leaves the
biases out. Activations are ``torch.nn.functional``'s by name (``"gelu"``
the exact erf form, as the JAX package's ``F.gelu``); hidden dropout is
``nn.Dropout``.
"""
from __future__ import annotations

import collections
import copy

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from .. import functional as NF

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _linear(i, o, bias_attr, device, dtype) -> nn.Linear:
    lin = nn.Linear(i, o, bias=bias_attr is not False, device=device,
                    dtype=dtype)
    with torch.no_grad():
        nn.init.xavier_normal_(lin.weight)
        if lin.bias is not None:
            lin.bias.zero_()
    return lin


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not {num_heads} "
                             "whole heads")
        kw = dict(bias_attr=bias_attr, device=device, dtype=dtype)
        self.q_proj = _linear(embed_dim, embed_dim, **kw)
        self.k_proj = _linear(self.kdim, embed_dim, **kw)
        self.v_proj = _linear(self.vdim, embed_dim, **kw)
        self.out_proj = _linear(embed_dim, embed_dim, **kw)

    def _reshape_heads(self, x):
        # (B, S, E) -> (B, S, H, D)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: the projected keys and values of ``key`` and
        ``value`` (cross attention over a fixed memory); otherwise an
        empty ``Cache`` that each call extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(
                self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._reshape_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None
        out = NF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, new_cache
        return out


def _act(name):
    return getattr(F, name)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, bias_attr, **kw)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, bias_attr, **kw)
        self.norm1 = nn.LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = nn.LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.activation = _act(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, bias_attr, **kw)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, bias_attr, **kw)
        self.norm1 = nn.LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = nn.LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm3 = nn.LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)
        self.activation = _act(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache = None
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, static_cache))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """The encoder-decoder Transformer; at its defaults Transformer-base
    (Vaswani et al. 2017, Table 3): d_model 512, 8 heads of 64, 6 + 6
    layers, FFN 2048, dropout 0.1."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                nn.LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                nn.LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``(length, length)`` fp32: 0 on and below the diagonal, -inf
        above it (a query sees itself and the keys before it)."""
        return torch.full((length, length), float("-inf"),
                          device=resolve_device(device)).triu(1)
