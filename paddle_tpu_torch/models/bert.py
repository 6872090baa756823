"""BERT encoder family (port of ``paddle_tpu.models.bert``).

One device, plain ``nn.Linear`` / ``nn.Embedding`` (the JAX package's
tensor-parallel mpu layers equal these on one device). Parameter names
match the JAX model's ``state_dict()`` leaf for leaf, so
``utils.convert.from_bert_state`` carries weights across; linear weights
are stored ``(out, in)`` as PyTorch does, where Paddle stores
``(in, out)``.

Attention is bidirectional and goes through the port's ``nn.functional``:

- no mask: ``scaled_dot_product_attention(is_causal=False)``, K-BSHD
  forward, K-BDQ and K-BDKV backward on CUDA;
- a 2-D ``(B, S)`` 0/1 padding mask: ``BertModel`` turns it into key-side
  segment ids (queries 0, keys 0 on a 1 and -1 on a 0) once, and each
  layer runs ``flash_attention(segment_ids=..., segment_ids_k=...,
  causal=False)``: K-SEG forward, K-SDQ and K-SDKV backward. The JAX
  package adds ``(m - 1) * 1e9`` to the scores, whose softmax gives the
  masked keys exactly 0 in fp32: the same result. A batch with a row
  that has no real token takes the JAX package's own additive ``(B, 1,
  1, S)`` mask instead (``padding_bias``), so that row attends uniformly
  to every key, as there;
- a 4-D additive mask (and that one): ``scaled_dot_product_attention(
  attn_mask=...)``, K-BSHD, K-BDQ and K-BDKV with the mask added in the
  kernels (their BIAS variants).

GELU is the exact erf form (the JAX package's ``F.gelu``), LayerNorm
eps 1e-12, the MLM decoder is tied to ``word_embeddings``, and the
embeddings add ``token_type_embeddings`` only when ``token_type_ids`` is
given, as the JAX model does. Hidden dropout is ``nn.Dropout``;
attention dropout (training mode) drops the probabilities inside the
kernels (their DROP variants, a Philox key a layer from
``framework.random.next_rng_key``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn import functional as NF

__all__ = ["BertConfig", "bert_base", "bert_large", "BertSelfAttention",
           "BertLayer", "BertEmbeddings", "BertModel", "BertForPretraining",
           "padding_key_ids", "padding_bias"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def padding_key_ids(attention_mask):
    """A ``(B, S)`` 0/1 padding mask -> ``(query ids, key ids)``, both
    ``(B, S)`` int32: queries 0, keys 0 where the mask is 1 and -1 where
    it is 0. A row with no 1 would see no key: ``BertModel`` gives such a
    batch ``padding_bias`` instead."""
    key_ids = torch.where(attention_mask != 0, 0, -1).to(torch.int32)
    return torch.zeros_like(key_ids), key_ids


def padding_bias(attention_mask):
    """The JAX model's additive form of a ``(B, S)`` padding mask:
    ``(m - 1) * 1e9`` as ``(B, 1, 1, S)`` fp32."""
    m = attention_mask.to(torch.float32)
    return ((m - 1.0) * 1e9)[:, None, None, :]


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x, attn_mask=None, segment_ids=None):
        """``segment_ids``: ``(query ids, key ids)`` from
        :func:`padding_key_ids`; ``attn_mask``: a 4-D additive mask."""
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # each (B, S, nH, D), strided views
        if segment_ids is not None:
            out, _ = NF.flash_attention(
                q, k, v, dropout=cfg.attention_dropout, causal=False,
                training=self.training, segment_ids=segment_ids[0],
                segment_ids_k=segment_ids[1])
        else:
            out = NF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=cfg.attention_dropout, training=self.training)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


class BertLayer(nn.Module):
    """Post-norm encoder block (original BERT ordering)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.attn = BertSelfAttention(cfg)
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.ffn_size)
        self.fc_out = nn.Linear(cfg.ffn_size, cfg.hidden_size)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None, segment_ids=None):
        x = self.ln_1(x + self.dropout(self.attn(x, attn_mask, segment_ids)))
        return self.ln_2(x + self.dropout(self.fc_out(F.gelu(self.fc_in(x)))))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            s = input_ids.shape[-1]
            position_ids = torch.arange(s, device=input_ids.device)
            position_ids = position_ids[None].expand(input_ids.shape[0], s)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids))
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = nn.ModuleList(BertLayer(cfg)
                                     for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        """Returns ``(hidden (B, S, H), pooled (B, H))``. A 2-D
        ``attention_mask`` is a 0/1 padding mask (key-side segment ids;
        the JAX model's additive mask when a row has no 1); a 4-D one is
        additive."""
        segment_ids = None
        if attention_mask is not None and attention_mask.dim() == 2:
            if bool((attention_mask != 0).any(-1).all()):
                segment_ids = padding_key_ids(attention_mask)
                attention_mask = None
            else:
                attention_mask = padding_bias(attention_mask)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for blk in self.encoder:
            x = blk(x, attention_mask, segment_ids)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForPretraining(nn.Module):
    """MLM + NSP heads, tied MLM decoder (standard BERT pretraining).

    ``device`` defaults to CUDA and raises without a card unless the
    caller passes ``"cpu"``. Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; a fresh one seeded 0 when omitted): Normal(0,
    ``initializer_range``) for linear weights and embeddings, zero
    biases, unit LayerNorm gains."""

    def __init__(self, cfg: BertConfig, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg)
        h = cfg.hidden_size
        self.mlm_transform = nn.Linear(h, h)
        self.mlm_ln = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon)
        self.nsp_head = nn.Linear(h, 2)
        self._init_weights(generator or torch.Generator().manual_seed(0))
        self.to(device=device, dtype=dtype)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Returns ``(mlm_logits (B, S, V), nsp_logits (B, 2))``."""
        hidden, pooled = self.bert(input_ids, token_type_ids,
                                   attention_mask)
        h = self.mlm_ln(F.gelu(self.mlm_transform(hidden)))
        mlm_logits = h @ self.bert.embeddings.word_embeddings.weight.T
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             mlm_mask=None):
        """MLM cross entropy (mean over every position, or over
        ``mlm_mask``'s ones) plus the NSP cross entropy; label -100 is
        ignored, as the JAX package's ``F.cross_entropy`` does."""
        mlm = F.cross_entropy(mlm_logits.reshape(-1, self.cfg.vocab_size),
                              mlm_labels.reshape(-1).long(),
                              reduction="none")
        if mlm_mask is not None:
            m = mlm_mask.reshape(-1).to(mlm.dtype)
            mlm = (mlm * m).sum() / m.sum().clamp(min=1.0)
        else:
            mlm = mlm.mean()
        nsp_labels = nsp_labels.reshape(-1).long()
        nsp = F.cross_entropy(nsp_logits, nsp_labels, reduction="sum")
        valid = (nsp_labels != -100).sum().clamp(min=1)
        return mlm + nsp / valid
