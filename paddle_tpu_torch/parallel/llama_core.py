"""Functional LLaMA core for training (port of
``paddle_tpu.parallel.llama_core``), one device: RMSNorm, rotary
embedding, grouped-query attention and SwiGLU over stacked parameters.

Parameters are one dict of STACKED leaves, the JAX package's pytree leaf
for leaf: ``wte`` ``(V, H)``, ``lnf_g`` ``(H,)``, the untied head
``lm_w`` ``(H, V)`` and ``blocks``, whose leaves carry a leading layer
dim ``(L, ...)``. Linear weights are ``(in, out)``, so ``x @ w``. The
masters stay fp32; each block casts them to the compute dtype where it
uses them, and ``_rms`` runs in fp32 through the gain (unlike the nn
model's ``rms_norm``, which casts before the weight multiply).

Attention runs over the packed ``(B, S, nh*d)`` layout: rotary
embedding rotates interleaved pairs per head in place of the layout, with
its tables cast to the activation dtype first (the nn model rotates in
fp32); the kv heads are expanded by a broadcast ``(nkv, 1, d) -> (nkv, g,
d)``, each repeated ``g`` times in a row; then
``ops.attention_dispatch.causal_attention_packed`` (K-PACK forward, K-DQ
and K-DKV backward on CUDA). Layers run in a Python loop, each under
``transformer_core._remat_wrap`` (every policy of the GPT core); the
block tags ``attn_out`` and ``ffn_in`` (the ``gate * up`` product, which
a policy naming it saves and the recompute skips) for ``"names:..."``,
where the JAX core does.

Not ported yet: ``llama_param_specs`` and ring attention (the
multi-device slice; ``ring`` other than None raises). Packed-sequence
LLaMA training raises in the trainer, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention_dispatch import causal_attention_packed
from . import transformer_core as tc

__all__ = ["llama_init", "llama_block", "llama_trunk", "llama_loss"]

Params = Dict[str, Any]


def _rms(x, g, eps):
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def llama_init(cfg, generator: Optional[torch.Generator] = None,
               dtype=torch.float32) -> Params:
    """The stacked-parameter dict (master weights), drawn on the CPU
    from ``generator``: normal(0, 0.02) weights, the residual
    projections (``o_w``, ``down_w``) at ``0.02 / sqrt(2L)``, gains 1."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    L = cfg.num_layers
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    std = 0.02
    resid_std = std / math.sqrt(2.0 * L)

    def nrm(shape, s=std):
        return (torch.randn(shape, generator=generator) * s).to(dtype)

    blocks = {
        "ln1_g": torch.ones((L, h), dtype=dtype),
        "q_w": nrm((L, h, q)),
        "k_w": nrm((L, h, kv)),
        "v_w": nrm((L, h, kv)),
        "o_w": nrm((L, q, h), resid_std),
        "ln2_g": torch.ones((L, h), dtype=dtype),
        "gate_w": nrm((L, h, f)),
        "up_w": nrm((L, h, f)),
        "down_w": nrm((L, f, h), resid_std),
    }
    return {
        "wte": nrm((v, h)),
        "blocks": blocks,
        "lnf_g": torch.ones((h,), dtype=dtype),
        "lm_w": nrm((h, v)),
    }


def _rope_tables(cfg, s: int, dtype, device=None):
    """``(cos, sin)`` ``(S, d/2)`` at positions ``0..S-1``, computed in
    float64 on the host as the JAX package does, then cast."""
    d = cfg.hidden_size // cfg.num_heads
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2) / d))
    ang = np.outer(np.arange(s), inv)
    return tuple(torch.from_numpy(f(ang)).to(device=device, dtype=dtype)
                 for f in (np.cos, np.sin))


def _apply_rope_packed(x, nh, cos, sin):
    """Rotary embedding over the packed ``(..., S, nh*d)`` layout: per
    head, rotate the (even, odd) pairs along d, in x's dtype."""
    lead = x.shape[:-1]
    s = x.shape[-2]
    d2 = cos.shape[-1]
    xh = x.reshape(*lead, nh, 2 * d2)
    x1, x2 = xh[..., 0::2], xh[..., 1::2]
    shape = (1,) * (len(lead) - 1) + (s, 1, d2)
    c = cos.to(x.dtype).reshape(shape)
    si = sin.to(x.dtype).reshape(shape)
    r1 = x1 * c - x2 * si
    r2 = x2 * c + x1 * si
    return torch.stack([r1, r2], dim=-1).reshape(*lead, nh * 2 * d2)


def llama_block(cfg, p: Params, x, cos, sin, compute_dtype=torch.bfloat16,
                ring=None):
    """One pre-norm LLaMA decoder block over ``x`` ``(B, S, H)``; ``p``
    holds one layer's leaves (no layer dim)."""
    eps = cfg.rms_norm_epsilon
    nh, nkv = cfg.num_heads, cfg.kv_heads
    d = x.shape[-1] // nh
    g = nh // nkv

    def c(t):  # params in the compute dtype; the master stays fp32
        return t.to(compute_dtype)

    y = _rms(x.float(), p["ln1_g"], eps).to(compute_dtype)
    q = _apply_rope_packed(y @ c(p["q_w"]), nh, cos, sin)
    kk = _apply_rope_packed(y @ c(p["k_w"]), nkv, cos, sin)
    vv = y @ c(p["v_w"])
    if g > 1:
        # expand kv heads to full heads for the shared attention kernel
        def expand(t):
            lead = t.shape[:-1]
            return (t.reshape(*lead, nkv, 1, d).expand(*lead, nkv, g, d)
                    .reshape(*lead, nh * d))

        kk, vv = expand(kk), expand(vv)
    a = tc.checkpoint_name(causal_attention_packed(q, kk, vv, nh, ring=ring),
                           "attn_out")
    x = x + a @ c(p["o_w"])
    y = _rms(x.float(), p["ln2_g"], eps).to(compute_dtype)
    z = tc.named_op("ffn_in", torch.mul, F.silu(y @ c(p["gate_w"])),
                    y @ c(p["up_w"]))
    return x + z @ c(p["down_w"])


def llama_trunk(cfg, params: Params, tokens, compute_dtype=torch.bfloat16,
                remat=True, ring=None, mesh=None):
    """Tokens -> hidden states ``(B, S, H)`` before the final norm;
    ``remat`` selects the recompute policy per layer."""
    if ring is not None:
        raise NotImplementedError(
            "llama_trunk: ring attention (sep > 1) is not ported; it comes "
            "with the multi-device slice")
    x = tc.embed_lookup(cfg, params["wte"], tokens, mesh, compute_dtype)
    cos, sin = _rope_tables(cfg, tokens.shape[-1], torch.float32, x.device)
    per_layer = {k: v.unbind(0) for k, v in params["blocks"].items()}

    def body(carry, *leaves):
        blk = dict(zip(per_layer, leaves))
        return llama_block(cfg, blk, carry, cos, sin, compute_dtype)

    run = tc._remat_wrap(body, remat)
    for i in range(cfg.num_layers):
        x = run(x, *(per_layer[k][i] for k in per_layer))
    return x


def llama_loss(cfg, params: Params, tokens, labels,
               compute_dtype=torch.bfloat16, remat=True, ring=None,
               mesh=None, chunk: int = 4096):
    """Mean next-token cross entropy: the trunk, the fp32 RMS final norm,
    then the chunked vocab projection through the untied ``lm_w``."""
    hidden = llama_trunk(cfg, params, tokens, compute_dtype, remat,
                         ring=ring, mesh=mesh)
    hidden = _rms(hidden.float(), params["lnf_g"], cfg.rms_norm_epsilon)
    return tc.chunked_xent_on(hidden, params["lm_w"], labels, compute_dtype,
                              chunk)
