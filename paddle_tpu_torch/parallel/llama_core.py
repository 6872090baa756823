"""Functional LLaMA core for training (port of
``paddle_tpu.parallel.llama_core``): RMSNorm, rotary embedding,
grouped-query attention and SwiGLU over stacked parameters.

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

Over a mesh the functions take this rank's shards under
``llama_param_specs`` (the GPT core's rules, ``transformer_core``):
q, k, v, gate and up split by columns over ``"model"`` (the kv heads too:
``nh_kv % mp`` must be 0, and each rank's q heads then share its kv
heads), o and down by rows with their products all-reduced, the
embedding and the untied head ``lm_w`` vocab-parallel where the vocab
divides; ZeRO-3 leaves gathered where used; on a ring the RoPE tables are
taken at this rank's global (zigzag) positions. Packed-sequence LLaMA
training raises in the trainer, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed import communication as comm
from ..distributed.mesh import P
from ..ops.attention_dispatch import causal_attention_packed
from ..ops.ring_attention import to_zigzag
from . import transformer_core as tc

__all__ = ["llama_init", "llama_param_specs", "llama_block", "llama_trunk",
           "llama_loss"]

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


def llama_param_specs(cfg, zero_stage: int = 1, pp: int = 1) -> Params:
    """The partition-spec tree of ``llama_init`` (the JAX package's, as
    data): Megatron TP (q/k/v/gate/up column-split on ``"model"``, o and
    down row-split, the vocab embedding split on the vocab, the LM head
    column-split on the vocab); ZeRO-3 shards the remaining big dim."""
    z = "sharding" if zero_stage >= 3 else None
    lyr = "pipe" if pp > 1 else None
    return {
        "wte": P("model", z),
        "blocks": {
            "ln1_g": P(lyr, None),
            "q_w": P(lyr, z, "model"),
            "k_w": P(lyr, z, "model"),
            "v_w": P(lyr, z, "model"),
            "o_w": P(lyr, "model", z),
            "ln2_g": P(lyr, None),
            "gate_w": P(lyr, z, "model"),
            "up_w": P(lyr, z, "model"),
            "down_w": P(lyr, "model", z),
        },
        "lnf_g": P(None),
        "lm_w": P(z, "model"),
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


def _row(x, w, tp):
    """A row-parallel product, all-reduced over ``tp``."""
    return x @ w if tp is None else comm.reduce_from(x @ w, tp)


def llama_block(cfg, p: Params, x, cos, sin, compute_dtype=torch.bfloat16,
                ring=None, mesh=None):
    """One pre-norm LLaMA decoder block over ``x`` ``(B, S, H)``; ``p``
    holds one layer's leaves (no layer dim): this rank's shards over a
    mesh's ``"model"`` axis, ``nh / mp`` query and ``nh_kv / mp`` kv
    heads."""
    eps = cfg.rms_norm_epsilon
    mp = tc._mp(mesh)
    tp = tc._tp(mesh)
    d = x.shape[-1] // cfg.num_heads
    nh, nkv = cfg.num_heads // mp, cfg.kv_heads // mp
    g = nh // nkv

    def c(t):  # params in the compute dtype; the master stays fp32
        return t.to(compute_dtype)

    y = comm.copy_to(_rms(x.float(), p["ln1_g"], eps).to(compute_dtype), tp)
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
    x = x + _row(a, c(p["o_w"]), tp)
    y = comm.copy_to(_rms(x.float(), p["ln2_g"], eps).to(compute_dtype), tp)
    z = tc.named_op("ffn_in", torch.mul, F.silu(y @ c(p["gate_w"])),
                    y @ c(p["up_w"]))
    return x + _row(z, c(p["down_w"]), tp)


def _local_tables(cfg, s_local, ring, device):
    """RoPE tables at this rank's global positions: 0..S-1 without a
    ring; on one the global tables (zigzag-ordered for the end-to-end
    zigzag layout), this rank's slice."""
    if ring is None:
        return _rope_tables(cfg, s_local, torch.float32, device)
    mesh, axis = ring[0], ring[1]
    n, i = mesh.shape[axis], mesh.coords[axis]
    cos, sin = _rope_tables(cfg, s_local * n, torch.float32, device)
    zz = tc.ring_zigzag_n(ring)
    if zz:
        cos, sin = to_zigzag(cos, zz, axis=0), to_zigzag(sin, zz, axis=0)
    sl = slice(i * s_local, (i + 1) * s_local)
    return cos[sl], sin[sl]


def llama_trunk(cfg, params: Params, tokens, compute_dtype=torch.bfloat16,
                remat=True, ring=None, mesh=None, specs=None):
    """Tokens -> hidden states ``(B, S, H)`` before the final norm;
    ``remat`` selects the recompute policy per layer; ``specs`` marks
    the ZeRO-3 leaves (``transformer_core.gpt_trunk``)."""
    wte = tc._zgather(params["wte"], specs and specs["wte"], mesh)
    x = tc.embed_lookup(cfg, wte, tokens, mesh, compute_dtype)
    cos, sin = _local_tables(cfg, tokens.shape[-1], ring, x.device)
    per_layer = {k: v.unbind(0) for k, v in params["blocks"].items()}
    bspecs = specs and specs["blocks"]

    def body(carry, *leaves):
        blk = tc._gather_layer(dict(zip(per_layer, leaves)), bspecs, mesh)
        return llama_block(cfg, blk, carry, cos, sin, compute_dtype,
                           ring=ring, mesh=mesh)

    run = tc._remat_wrap(body, remat)
    for i in range(cfg.num_layers):
        x = run(x, *(per_layer[k][i] for k in per_layer))
    return x


def llama_loss(cfg, params: Params, tokens, labels,
               compute_dtype=torch.bfloat16, remat=True, ring=None,
               mesh=None, chunk: int = 4096, specs=None):
    """Mean next-token cross entropy: the trunk, the fp32 RMS final norm,
    then the chunked vocab projection through the untied ``lm_w``
    (vocab-parallel where the vocab divides by the ``"model"`` axis)."""
    hidden = llama_trunk(cfg, params, tokens, compute_dtype, remat,
                         ring=ring, mesh=mesh, specs=specs)
    hidden = _rms(hidden.float(), params["lnf_g"], cfg.rms_norm_epsilon)
    lm_w = tc._zgather(params["lm_w"], specs and specs["lm_w"], mesh)
    return tc.chunked_xent_on(hidden, lm_w, labels, compute_dtype, chunk,
                              mesh=mesh,
                              vocab_parallel=tc._use_vp_embed(cfg, mesh))
