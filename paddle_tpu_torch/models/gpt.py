"""GPT model family (port of ``paddle_tpu.models.gpt``).

One device, plain ``nn.Linear`` / ``nn.Embedding`` (the JAX package's
tensor-parallel mpu layers are not ported). Parameter names match the
JAX model's ``state_dict()`` leaf for leaf, so
``utils.convert.from_paddle_tpu_state`` carries weights across; linear
weights are stored ``(out, in)`` as PyTorch does, where Paddle stores
``(in, out)``.

The paged-KV serving path (``serving.kv_cache.PagedForwardState``)
threads through ``GPTModel.forward(caches=...)``; the full forward with
no cache runs ``ops.attention_dispatch.causal_attention``, which is
differentiable (K-BSHD forward, K-BDQ and K-BDKV backward on CUDA), so
the nn API trains: ``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` ->
``loss.backward()``. In training mode ``attention_dropout`` drops the
probabilities inside those kernels (their DROP variants, a Philox key a
layer from ``framework.random.next_rng_key``, where the JAX model draws
its key in ``scaled_dot_product_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention_dispatch import causal_attention

__all__ = ["GPTConfig", "gpt_tiny", "gpt_345m", "gpt_1p3b", "GPTAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_position_embeddings=256, **kw)


def gpt_345m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048, **kw)


class GPTAttention(nn.Module):
    """Causal self-attention with fused QKV (columns ``[q | k | v]``)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)
        self.resid_dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, cache=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # each (B, S, nH, D), strided views
        if cache is not None:
            # paged KV cache (serving.kv_cache.PagedLayerView): scatter the
            # fresh K/V into the layer's pool pages, then run the mode's
            # attention (paged decode kernel / segmented prefill / batch
            # prefill)
            cache.update(k, v)
            out = cache.attend(q, k, v)
        else:
            # the unbind views go to the kernels with their row stride
            out = causal_attention(
                q, k, v,
                dropout_p=cfg.attention_dropout if self.training else 0.0)
        out = out.reshape(b, s, cfg.hidden_size)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.ffn_size)
        self.fc_out = nn.Linear(cfg.ffn_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(
            F.gelu(self.fc_in(x), approximate="tanh")))


class GPTDecoderLayer(nn.Module):
    """Pre-norm transformer block (GPT-2/3 style)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.attn = GPTAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, cache=None):
        x = x + self.attn(self.ln_1(x), cache=cache)
        return x + self.mlp(self.ln_2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            s = input_ids.shape[-1]
            position_ids = torch.arange(s, device=input_ids.device)
            position_ids = position_ids[None].expand(input_ids.shape[0], s)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids))
        return self.dropout(emb)


class GPTModel(nn.Module):
    """The transformer trunk: tokens -> final hidden states."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        self.h = nn.ModuleList(GPTDecoderLayer(cfg)
                               for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                 eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, caches=None):
        """``caches`` is a paged serving state
        (``serving.kv_cache.PagedForwardState``): each block writes
        through its layer view and the pools are updated in place."""
        x = self.embeddings(input_ids, position_ids)
        for i, blk in enumerate(self.h):
            x = blk(x, cache=None if caches is None else caches.view(i))
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """Trunk + (tied) LM head. ``forward`` returns logits; ``generate``
    decodes greedily or by top-k sampling through the paged serving
    engine.

    ``device`` defaults to CUDA and raises without a card unless the
    caller passes ``"cpu"``. Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; a fresh one seeded 0 when omitted): Normal(0,
    ``initializer_range``) for linear weights and embeddings, zero
    biases, unit LayerNorm gains, as the JAX package initialises them.
    """

    def __init__(self, cfg: GPTConfig, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False))
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

    def _logits(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return hidden @ self.gpt.embeddings.word_embeddings.weight.T

    def forward(self, input_ids, position_ids=None):
        return self._logits(self.gpt(input_ids, position_ids))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0):
        """Greedy (``top_k=0``; ``temperature <= 0`` is greedy too) or
        top-k sampling through the paged KV cache (``ServingEngine``):
        one bucketed batch prefill, then one bucketed single-token
        decode per step. ``input_ids`` (B, S) array or tensor; returns
        (B, S + max_new_tokens) ids as a CPU tensor of the input's
        dtype."""
        self.eval()
        ids = (input_ids.detach().cpu().numpy()
               if isinstance(input_ids, torch.Tensor)
               else np.asarray(input_ids))
        if int(max_new_tokens) <= 0:  # no-op, like the JAX package
            return torch.from_numpy(ids.copy())
        b, s = ids.shape
        total = s + int(max_new_tokens)
        if total > self.cfg.max_position_embeddings:
            raise ValueError(
                f"generate: prompt ({s}) + max_new_tokens "
                f"({int(max_new_tokens)}) = {total} exceeds "
                f"max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        engine = self._decode_engine(b, total)
        engine.refresh_params()
        ps = engine.kv.page_size
        n_pages = -(-total // ps)
        pages = [engine.pool.allocate(n_pages) for _ in range(b)]
        try:
            pt = np.zeros((b, engine.max_pages_per_seq), np.int32)
            for i, pg in enumerate(pages):
                pt[i, :len(pg)] = pg

            def sample(logits):
                if top_k and temperature > 0:
                    lv = torch.from_numpy(logits)
                    kth = torch.topk(lv, top_k, dim=-1).values[..., -1:]
                    lv = lv.masked_fill(lv < kth, float("-inf"))
                    probs = torch.softmax(lv / temperature, dim=-1)
                    return torch.multinomial(probs, 1)[:, 0].numpy()
                return np.argmax(logits, axis=-1)

            out = ids
            logits = engine.prefill_batch(list(ids.astype(np.int32)), pages)
            nxt = sample(logits)
            out = np.concatenate([out, nxt[:, None].astype(out.dtype)], 1)
            lens = np.full((b,), s, np.int32)
            for _ in range(int(max_new_tokens) - 1):
                logits = engine.decode(nxt.astype(np.int32), pt, lens)
                lens = lens + 1
                nxt = sample(logits)
                out = np.concatenate(
                    [out, nxt[:, None].astype(out.dtype)], 1)
        finally:
            for pg in pages:
                engine.pool.free(pg)
        return torch.from_numpy(out)

    def _decode_engine(self, batch: int, total_len: int):
        """Cached serving engine per (batch, length) bucket: repeated
        generate calls at similar sizes reuse the page pool. At most two
        are kept (each preallocates a pool for its whole bucket)."""
        from ..serving.bucketing import bucket_for
        from ..serving.engine import ServingConfig, ServingEngine

        mpe = self.cfg.max_position_embeddings
        key = (bucket_for(batch),
               bucket_for(total_len, minimum=32, maximum=mpe))
        engines = self.__dict__.setdefault("_gen_engines", {})
        if key in engines:
            engines[key] = engines.pop(key)   # LRU: re-insert on hit
        else:
            while len(engines) >= 2:
                engines.pop(next(iter(engines)))
            engines[key] = ServingEngine(self, ServingConfig(
                max_model_len=key[1], max_batch=key[0],
                max_prefill_tokens=max(64, key[0] * key[1])))
        return engines[key]


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy over ``(B, S, V)`` logits (the JAX
    package's ``GPTPretrainingCriterion`` around ``ParallelCrossEntropy``,
    one device): per-token ``-log_softmax(logits)[label]``, then the mean,
    or with ``loss_mask`` ``sum(per * mask) / max(sum(mask), 1)``."""

    def __init__(self, cfg: Optional[GPTConfig] = None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        logp = F.log_softmax(logits, dim=-1)
        per = -logp.gather(-1, labels.long()[..., None])[..., 0]
        if loss_mask is not None:
            m = loss_mask.to(per.dtype)
            return (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        return per.mean()
