"""Functional GPT core for training (port of
``paddle_tpu.parallel.transformer_core``), one device.

Parameters are one dict of STACKED leaves, the JAX package's pytree leaf
for leaf: ``wte`` ``(V, H)``, ``wpe`` ``(P, H)``, ``lnf_g``/``lnf_b``
``(H,)`` and ``blocks``, whose every leaf carries a leading layer dim
``(L, ...)``. Linear weights are ``(in, out)``, so ``x @ w`` as in JAX.
The masters stay fp32; each block casts them to the compute dtype where
it uses them, LayerNorm runs in fp32 on the fp32 gains.

The JAX package scans over the layer dim; here a Python loop runs the
layers, each under ``torch.utils.checkpoint`` unless ``remat`` is off
(``_remat_wrap``): True or ``"full"`` keeps only the block's input and
recomputes the block in the backward pass, so the K-PACK forward
launches twice per layer per step; ``"dots"`` and ``"names:a,b"`` are
the JAX package's selective policies, run through
``create_selective_checkpoint_contexts``. ``"dots"`` saves every matrix
product (``aten.mm``, ``aten.addmm``) and recomputes the rest, the
attention forward included; ``"names:..."`` saves the values tagged
with those names, each as the output of the operator that makes it
(``named_op``): ``ffn_in``, the fc_in product, which the recompute then
skips; ``attn_out``, kept as a view, which spares no recompute (the
kernel still runs for its lse, as in JAX); and ``attn_out_kernel`` and
``attn_lse``, the attention forward op's own outputs, which are saved
(and the kernel skipped in the recompute) only when both are named.
Attention is
``ops.attention_dispatch.causal_attention_packed`` over q, k, v taken as
column slices of the fused qkv projection.

``segment_ids``/``positions`` ``(B, S)`` switch on the packed-sequence
path (rows packed by ``io.packing``): cross-document attention is masked
in every block (K-SEG, K-SDQ, K-SDKV), positions reset per document, and
the loss averages over real within-document labels only
(``packed_loss_mask``).

Not ported yet, and raising ``NotImplementedError``: ring attention and
the vocab-parallel embedding (the multi-device slice).
"""
from __future__ import annotations

import contextvars
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention_dispatch import causal_attention_packed
from ..ops.kernels.flash_attention_packed import FORWARD_OPS, OUTPUT_NAMES

__all__ = ["gpt_init", "gpt_block", "embed_lookup", "gpt_embed",
           "gpt_trunk", "gpt_logits", "softmax_xent", "gpt_forward",
           "chunked_xent_on", "chunked_xent", "packed_loss_mask",
           "gpt_loss", "checkpoint_name", "named_op"]

Params = Dict[str, Any]


def _norm(x, g, b, eps):
    """LayerNorm with the population variance (``jnp.var``)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * g + b


def gpt_init(cfg, generator: Optional[torch.Generator] = None,
             dtype=torch.float32) -> Params:
    """The stacked-parameter dict (master weights, fp32), drawn on the
    CPU from ``generator``: normal(0, initializer_range) weights, the
    residual projections (``out_w``, ``fc_out_w``) at the GPT-2 depth-
    scaled ``std / sqrt(2L)``, ``wpe`` at 0.01, gains 1 and biases 0."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    L = cfg.num_layers
    std = cfg.initializer_range
    resid_std = std / math.sqrt(2.0 * L)

    def nrm(shape, s=std):
        return (torch.randn(shape, generator=generator) * s).to(dtype)

    blocks = {
        "ln1_g": torch.ones((L, h), dtype=dtype),
        "ln1_b": torch.zeros((L, h), dtype=dtype),
        "qkv_w": nrm((L, h, 3 * h)),
        "qkv_b": torch.zeros((L, 3 * h), dtype=dtype),
        "out_w": nrm((L, h, h), resid_std),
        "out_b": torch.zeros((L, h), dtype=dtype),
        "ln2_g": torch.ones((L, h), dtype=dtype),
        "ln2_b": torch.zeros((L, h), dtype=dtype),
        "fc_in_w": nrm((L, h, f)),
        "fc_in_b": torch.zeros((L, f), dtype=dtype),
        "fc_out_w": nrm((L, f, h), resid_std),
        "fc_out_b": torch.zeros((L, h), dtype=dtype),
    }
    return {
        "wte": nrm((v, h)),
        "wpe": nrm((cfg.max_position_embeddings, h), 0.01),
        "blocks": blocks,
        "lnf_g": torch.ones((h,), dtype=dtype),
        "lnf_b": torch.zeros((h,), dtype=dtype),
    }


# -- the remat policies' tags -------------------------------------------------
#
# The JAX package tags values with ``jax.ad_checkpoint.checkpoint_name``;
# its ``save_only_these_names`` policy saves them, and its recompute drops
# whatever the saved values make unneeded. A PyTorch recompute reruns the
# block's Python, and a selective policy sees operators, not values, so
# a tag here names the operator that makes the value: ``named_op(name,
# op, *args)`` runs ``op(*args)``, one operator, and under a
# ``"names:..."`` policy that names ``name`` the policy saves its output,
# so the recompute takes the saved value instead of running the operator
# again. The operators are the JAX package's tagged values: ``ffn_in`` is
# the fc_in product (GPT) or ``gate * up`` (LLaMA), and the recompute
# skips that product, as JAX's does; ``attn_out`` is the attention
# output, tagged through ``aten.alias``, a view of the forward op's o:
# the value is kept without a copy, and the forward kernel still runs
# again for its lse, as in JAX. Outside such a policy a tag only runs
# its operator.

_NAMES = contextvars.ContextVar("remat_names", default=())
_SAVING = contextvars.ContextVar("remat_saving", default=False)


def named_op(name: Optional[str], op, *args):
    """``op(*args)``, one operator whose output the JAX package tags
    ``name``: saved by a ``"names:..."`` policy that names it (and not
    run again in the recompute), else simply run."""
    if name not in _NAMES.get():
        return op(*args)
    token = _SAVING.set(True)
    try:
        return op(*args)
    finally:
        _SAVING.reset(token)


def checkpoint_name(x, name: str):
    """Tag ``x`` itself as ``name``: under a policy that names it, a view
    of ``x`` that the policy saves (``named_op`` over ``aten.alias``),
    else ``x``."""
    if name not in _NAMES.get():
        return x
    return named_op(name, torch.ops.aten.alias.default, x)


def _dense(x, w, b, name=None):
    """``x @ w + b`` over the last dim, one GEMM with the bias; ``name``
    tags the product (``named_op``)."""
    out = named_op(name, torch.addmm, b, x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def gpt_block(cfg, p: Params, x, compute_dtype=torch.bfloat16, ring=None,
              seg=None):
    """One pre-norm decoder block over ``x`` ``(B, S, H)``; ``p`` holds
    one layer's leaves (no layer dim). q, k, v stay packed
    ``(B, S, NH*D)``: heads are column slices of the fused qkv
    projection, so no head transpose is ever made. ``seg`` ``(B, S)``
    int32 masks attention across segments."""
    eps = cfg.layer_norm_epsilon
    hp = cfg.num_heads * cfg.head_dim

    def c(t):  # params in the compute dtype; the master stays fp32
        return t.to(compute_dtype)

    y = _norm(x.float(), p["ln1_g"], p["ln1_b"], eps).to(compute_dtype)
    qkv = _dense(y, c(p["qkv_w"]), c(p["qkv_b"]))
    a = causal_attention_packed(qkv[..., :hp], qkv[..., hp:2 * hp],
                                qkv[..., 2 * hp:], cfg.num_heads, ring=ring,
                                segment_ids=seg)
    a = checkpoint_name(a, "attn_out")
    x = x + _dense(a, c(p["out_w"]), c(p["out_b"]))
    y = _norm(x.float(), p["ln2_g"], p["ln2_b"], eps).to(compute_dtype)
    y = F.gelu(_dense(y, c(p["fc_in_w"]), c(p["fc_in_b"]), "ffn_in"),
               approximate="tanh")
    return x + _dense(y, c(p["fc_out_w"]), c(p["fc_out_b"]))


def embed_lookup(cfg, wte, tokens, mesh=None, compute_dtype=torch.bfloat16):
    """Token embedding gather, cast to the compute dtype. The
    vocab-parallel lookup over a mesh is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "embed_lookup: the vocab-parallel embedding over a mesh comes "
            "with the multi-device slice")
    return F.embedding(tokens, wte).to(compute_dtype)


def gpt_embed(cfg, params: Params, tokens, compute_dtype=torch.bfloat16,
              mesh=None, ring=None, positions=None):
    """Tokens ``(B, S)`` -> ``(B, S, H)``: the token embedding plus the
    learned positional embedding at positions ``0..S-1``, or at
    ``positions`` ``(B, S)`` (the packed path resets them at each
    document start)."""
    if ring is not None:
        raise NotImplementedError(
            "gpt_embed: the zigzag ring layout comes with the multi-device "
            "slice")
    x = embed_lookup(cfg, params["wte"], tokens, mesh, compute_dtype)
    if positions is not None:
        return x + params["wpe"][positions.long()].to(compute_dtype)
    s = tokens.shape[-1]
    return x + params["wpe"][:s][None].to(compute_dtype)


def gpt_logits(cfg, params: Params, x, compute_dtype=torch.bfloat16):
    """Final norm + tied LM head over ``(B, S, H)`` -> fp32 ``(B, S, V)``."""
    x = _norm(x.float(), params["lnf_g"], params["lnf_b"],
              cfg.layer_norm_epsilon)
    logits = x.to(compute_dtype) @ params["wte"].t().to(compute_dtype)
    return logits.float()


def softmax_xent(logits, labels):
    """Mean cross entropy of fp32 logits against int labels."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def gpt_forward(cfg, params: Params, tokens, compute_dtype=torch.bfloat16,
                remat=True, ring=None, mesh=None):
    """Tokens -> fp32 logits."""
    x = gpt_trunk(cfg, params, tokens, compute_dtype, remat, ring=ring,
                  mesh=mesh)
    return gpt_logits(cfg, params, x, compute_dtype)


# the products ``"dots"`` saves: JAX's dots_with_no_batch_dims_saveable
# (every ``x @ w`` of the blocks reaches the dispatcher as one of these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_wrap(body, remat):
    """remat selector: False/None/"none" runs ``body`` as it is; True or
    "full" keeps only the block's input and recomputes the block in the
    backward pass (``torch.utils.checkpoint``, non-reentrant); "dots"
    saves the matrix products' outputs and recomputes the rest; "names:
    a,b" saves only the outputs of the operators tagged a or b
    (``named_op``), which the recompute then does not run again: the
    fc_in product or ``gate * up`` for ``ffn_in``, a view of the
    attention output for ``attn_out`` (no operator spared), and the
    attention forward op, kernel and all, when both of its outputs'
    names, ``attn_out_kernel`` and ``attn_lse``, are named. A name
    nothing carries saves nothing, as in the JAX package."""
    if remat in (False, None, "none"):
        return body
    if remat is True or remat == "full":
        return lambda *args: checkpoint(body, *args, use_reentrant=False,
                                        preserve_rng_state=False)
    if remat == "dots":
        names, saved = (), _DOTS
    elif isinstance(remat, str) and remat.startswith("names:"):
        names = tuple(n for n in remat[len("names:"):].split(",") if n)
        saved = FORWARD_OPS if set(OUTPUT_NAMES) <= set(names) else ()
    else:
        raise ValueError(f"unknown remat policy: {remat!r}")

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved or _SAVING.get()
                else CheckpointPolicy.PREFER_RECOMPUTE)

    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   policy)

    def tagged(*args):
        token = _NAMES.set(names)
        try:
            return body(*args)
        finally:
            _NAMES.reset(token)

    return lambda *args: checkpoint(tagged, *args, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=context_fn)


def gpt_trunk(cfg, params: Params, tokens, compute_dtype=torch.bfloat16,
              remat=True, ring=None, mesh=None, segment_ids=None,
              positions=None):
    """Tokens -> final hidden states ``(B, S, H)``, before the vocab
    projection; ``remat`` selects the recompute policy per layer.
    ``segment_ids``/``positions`` ``(B, S)`` switch on the packed path:
    every layer (and its recompute) closes over the same int32 ids."""
    x = gpt_embed(cfg, params, tokens, compute_dtype, mesh=mesh, ring=ring,
                  positions=positions)
    seg = (segment_ids.to(torch.int32).contiguous()
           if segment_ids is not None else None)
    # one unbind per leaf: its backward stacks the layers' grads at once
    per_layer = {k: v.unbind(0) for k, v in params["blocks"].items()}

    def body(carry, *leaves):
        blk = dict(zip(per_layer, leaves))
        return gpt_block(cfg, blk, carry, compute_dtype, ring=ring, seg=seg)

    run = _remat_wrap(body, remat)
    for i in range(cfg.num_layers):
        x = run(x, *(per_layer[k][i] for k in per_layer))
    return x


def chunked_xent_on(hidden, proj_w, labels, compute_dtype=torch.bfloat16,
                    chunk: int = 4096, token_mask=None):
    """Mean cross entropy over already-normed hidden states against an
    ``(H, V)`` projection, without the full ``(tokens, V)`` logits: each
    ``chunk`` of tokens makes its fp32 logits, reduces them, and is
    recomputed in the backward pass. A ragged last chunk is simply
    shorter; the mean divides by the token count, as the JAX package's
    padded version does. ``token_mask`` (labels' shape, 0/1) drops tokens
    from both the sum and the denominator, which is then
    ``max(sum(mask), 1)``."""
    h = hidden.shape[-1]
    t = hidden.reshape(-1, h)
    lab = labels.reshape(-1).long()
    n = t.shape[0]
    m = token_mask.reshape(-1).float() if token_mask is not None else None
    w = proj_w.to(compute_dtype)

    def body(h_c, l_c, m_c):
        logits = (h_c.to(compute_dtype) @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, l_c[:, None])[:, 0]
        nll = lse - gold
        return (nll if m_c is None else nll * m_c).sum()

    total = None
    for i in range(0, n, chunk):
        part = checkpoint(body, t[i:i + chunk], lab[i:i + chunk],
                          None if m is None else m[i:i + chunk],
                          use_reentrant=False, preserve_rng_state=False)
        total = part if total is None else total + part
    if m is None:
        return total / n
    return total / torch.clamp(m.sum(), min=1.0)


def packed_loss_mask(segment_ids):
    """``(B, S)`` segment ids -> ``(B, S)`` float 0/1 label-validity mask
    for next-token training on packed rows: label i (token i+1) counts
    only where position i is a real token (``seg >= 0``) and position
    i+1 exists in the same segment, so boundary and pad slots add
    nothing to the loss or, through it, to any gradient."""
    seg = segment_ids.to(torch.int32)
    nxt = torch.cat([seg[..., 1:], torch.full_like(seg[..., :1], -2)],
                    dim=-1)
    return ((seg >= 0) & (seg == nxt)).float()


def chunked_xent(cfg, params: Params, hidden, labels,
                 compute_dtype=torch.bfloat16, chunk: int = 4096,
                 token_mask=None):
    """Final norm, then the chunked cross entropy through the tied head
    (``wte.T``)."""
    hidden = _norm(hidden.float(), params["lnf_g"], params["lnf_b"],
                   cfg.layer_norm_epsilon)
    return chunked_xent_on(hidden, params["wte"].t(), labels, compute_dtype,
                           chunk, token_mask=token_mask)


def gpt_loss(cfg, params: Params, tokens, labels,
             compute_dtype=torch.bfloat16, remat=True, ring=None, mesh=None,
             segment_ids=None, positions=None):
    """Mean next-token cross entropy over the whole batch. With
    ``segment_ids``/``positions`` (the packed path) cross-segment
    attention is masked, positions reset per segment, and the mean runs
    over real within-segment labels only."""
    hidden = gpt_trunk(cfg, params, tokens, compute_dtype, remat, ring=ring,
                       mesh=mesh, segment_ids=segment_ids,
                       positions=positions)
    mask = packed_loss_mask(segment_ids) if segment_ids is not None else None
    return chunked_xent(cfg, params, hidden, labels, compute_dtype,
                        token_mask=mask)
