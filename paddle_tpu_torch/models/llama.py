"""LLaMA model family (port of ``paddle_tpu.models.llama``): RMSNorm,
rotary embedding, SwiGLU and grouped-query attention.

One device, plain ``nn.Linear`` (``(out, in)`` weights, no bias) and
``nn.Embedding``. Parameter names match the JAX model's ``state_dict()``
leaf for leaf, so ``utils.convert.from_llama_state`` carries weights
across (transposing Paddle's ``(in, out)`` linear weights).

Rotary embedding rotates INTERLEAVED pairs ``(x[..., 0::2],
x[..., 1::2])`` and re-interleaves them, as the JAX package does (not the
half-split ``rotate_half`` of other codebases); it computes in fp32 and
casts the result to the input's dtype. ``rms_norm`` casts the normalised
value to x's dtype before the weight multiply, as the JAX
``F.rms_norm`` does.

The paged-KV serving path (``serving.kv_cache.PagedForwardState``)
threads through ``LlamaModel.forward(caches=...)``: keys are stored with
their rotation applied, the pools keep ``kv_heads`` heads, and the paged
kernels (K-DEC, K-MQ) map query head ``h`` to kv head ``h // group``. The
forward with no cache expands the kv heads by ``repeat_interleave`` and
runs ``ops.attention_dispatch.causal_attention`` (K-BSHD forward, K-BDQ
and K-BDKV backward on CUDA), so the nn API trains. The JAX model's
tuple-of-tensors cache is not ported; like the JAX model there is no
``generate()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention_dispatch import causal_attention

__all__ = ["LlamaConfig", "llama_tiny", "llama_7b", "apply_rotary_pos_emb",
           "rms_norm", "RMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # GQA; None -> MHA
    intermediate_size: Optional[int] = None  # default 8/3 * hidden rounded
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_epsilon: float = 1e-6
    initializer_range: float = 0.02

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        # the LLaMA rule: 2/3 * 4h rounded up to a multiple of 256
        x = int(2 * 4 * self.hidden_size / 3)
        return 256 * ((x + 255) // 256)


def llama_tiny(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=2,
                       max_position_embeddings=256, **kw)


def llama_7b(**kw) -> LlamaConfig:
    """LLaMA-7B (Touvron et al. 2023, Table 2): hidden 4096, 32 layers,
    32 heads of 128, FFN 11008, vocab 32000."""
    return LlamaConfig(**kw)


def _rope(x, positions, theta: float):
    """Rotary embedding of ``x`` ``(B, S, H, D)`` at ``positions``
    ``(B, S)``: interleaved pairs, fp32 arithmetic, x's dtype out."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs            # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rotary_pos_emb(q, k, positions, theta=10000.0):
    """Rotary embedding of ``(B, S, H, D)`` q and k at ``positions``
    ``(B, S)``."""
    return _rope(q, positions, theta), _rope(k, positions, theta)


def rms_norm(x, weight=None, epsilon=1e-6):
    """``x * rsqrt(mean(x²) + eps)``, the mean in fp32, cast to x's dtype,
    then times ``weight``."""
    var = x.float().square().mean(-1, keepdim=True)
    out = (x * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


def _linear(n_in, n_out, **factory):
    return nn.Linear(n_in, n_out, bias=False, **factory)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = _linear(h, cfg.num_heads * d, **factory)
        self.k_proj = _linear(h, cfg.kv_heads * d, **factory)
        self.v_proj = _linear(h, cfg.kv_heads * d, **factory)
        self.o_proj = _linear(cfg.num_heads * d, h, **factory)

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        nh, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).view(b, s, nh, d)
        k = self.k_proj(x).view(b, s, nkv, d)
        v = self.v_proj(x).view(b, s, nkv, d)
        q, k = apply_rotary_pos_emb(q, k, positions, cfg.rope_theta)
        if cache is not None:
            # paged KV cache (serving.kv_cache.PagedLayerView): the pools
            # store rotated keys and keep kv_heads heads; the paged
            # kernels map query heads to kv heads, the prefill paths
            # expand inside the view
            cache.update(k, v)
            out = cache.attend(q, k, v)
        else:
            rep = nh // nkv
            if rep > 1:   # GQA: each kv head repeated rep times in a row
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = causal_attention(q, k, v)
        return self.o_proj(out.reshape(b, s, nh * d))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.gate_proj = _linear(h, f, **factory)
        self.up_proj = _linear(h, f, **factory)
        self.down_proj = _linear(f, h, **factory)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        eps = cfg.rms_norm_epsilon
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, **factory)
        self.self_attn = LlamaAttention(cfg, **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps,
                                                **factory)
        self.mlp = LlamaMLP(cfg, **factory)

    def forward(self, x, positions, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), positions,
                               cache=cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """The trunk: tokens -> final hidden states (after the last norm)."""

    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, **factory)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_epsilon, **factory)

    def forward(self, input_ids, position_ids=None, caches=None):
        """``caches`` is a paged serving state
        (``serving.kv_cache.PagedForwardState``): each layer writes
        through its view and the pools are updated in place."""
        b, s = input_ids.shape[0], input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)
            position_ids = position_ids[None].expand(b, s)
        x = self.embed_tokens(input_ids)
        for i, blk in enumerate(self.layers):
            x = blk(x, position_ids,
                    cache=None if caches is None else caches.view(i))
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Trunk (``.model``) + untied LM head (``.lm_head``); ``forward``
    returns logits.

    ``device`` defaults to CUDA and raises without a card unless the
    caller passes ``"cpu"``. The parameters are allocated on ``device``
    in ``dtype`` directly (LLaMA-7B in bf16 is 13.5 GB: no host copy is
    made) and drawn from ``generator``, a ``torch.Generator`` on that
    device (a fresh one seeded 0 when omitted): Normal(0,
    ``initializer_range``) for every linear and embedding weight, ones
    for the norms, as the JAX package initialises them.
    """

    def __init__(self, cfg: LlamaConfig, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        meta = {"device": "meta", "dtype": dtype}
        self.model = LlamaModel(cfg, **meta)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, **meta)
        self.to_empty(device=device)
        self._init_weights(generator or torch.Generator(
            device=device).manual_seed(0))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, input_ids, position_ids=None):
        return self.lm_head(self.model(input_ids, position_ids))
