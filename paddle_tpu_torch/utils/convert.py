"""Carry weights from the JAX package's GPT, LLaMA and BERT to the port's.

``from_gpt_params`` maps the JAX trainer's stacked-parameter pytree
(``paddle_tpu.parallel.transformer_core.gpt_init``, as numpy) onto the
port's ``paddle_tpu_torch.parallel.transformer_core`` dict: the same
names, shapes and ``(in, out)`` layout, leaf for leaf.

``from_paddle_tpu_state`` maps ``paddle_tpu``'s
``GPTForCausalLM.state_dict()`` (as numpy arrays) onto
``paddle_tpu_torch``'s ``GPTForCausalLM.state_dict()``. The module names
match leaf for leaf; the layouts that differ:

- Paddle linear weights are ``(in, out)`` and become ``nn.Linear``'s
  ``(out, in)`` by a transpose (the fused QKV's output columns stay
  ``[q | k | v]``, each ``nh*d`` wide);
- the LM head is tied to ``word_embeddings.weight`` when
  ``tie_word_embeddings`` (no ``lm_head`` leaf on either side).

``from_llama_state`` and ``from_llama_params`` do the same for LLaMA:
``LlamaForCausalLM.state_dict()`` (every linear weight transposed, the
untied ``lm_head`` included) and ``llama_core.llama_init``'s pytree
(same names, same ``(in, out)`` layout). ``from_bert_state`` maps
``BertForPretraining.state_dict()`` (the encoder's, pooler's and heads'
linear weights transposed; the MLM decoder is tied to
``word_embeddings``, so it has no leaf).

Every leaf must be accounted for: an unknown or a missing name raises.

``from_transformer_state`` and ``from_fused_transformer_state`` map the
``state_dict()`` of the JAX package's transformer layers
(``nn.layer.transformer``: ``MultiHeadAttention`` up to ``Transformer``;
``incubate.nn``'s fused layers) onto the port's, key for key: the linear
weights (``q_proj`` ... ``out_proj``, ``linear1``, ``linear2``; the fused
``qkv_weight``, ``linear_weight``, ``linear1_weight``,
``linear2_weight``) transposed from ``(in, out)``, everything else
(biases, LayerNorm scales) as it is, checked name for name and shape
for shape against the port's module's own ``state_dict()``.

``shard_params`` cuts those stacked params (GPT or LLaMA, numpy or
tensors) into one rank's shards under a layout: a partition-spec tree
(``transformer_core.gpt_param_specs`` / ``llama_core.llama_param_specs``
after ``hybrid.sanitize_specs``) and the mesh's axis sizes; each dim
with an entry is cut into contiguous pieces, the rank's row-major
coordinate along the entry's axes picking one. ``unshard_params`` puts
every rank's shards back together. The fused GPT ``qkv_w``/``qkv_b`` are
first reordered head-aligned (``head_aligned``): the JAX package's
``P(z, "model")`` cuts the ``3H`` columns contiguously, mixing q and k
columns on one rank (GSPMD keeps the math right whatever the cut), but
an explicit tensor-parallel block needs each rank's q, k and v heads, so
rank m's columns are ``[q heads of m | k heads of m | v heads of m]``.
``shard_pieces`` goes the other way for a checkpoint: a rank's shard of
one leaf as pieces of the JAX layout's global value, each with its
global index (three column runs for a head-aligned qkv shard), and none
when a lower rank holds the same shard.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .tree import flatten, unflatten

__all__ = ["from_paddle_tpu_state", "expected_leaves", "from_bert_state",
           "expected_bert_leaves", "from_gpt_params",
           "expected_gpt_params", "from_llama_state", "expected_llama_leaves",
           "from_llama_params", "expected_llama_params", "qkv_order",
           "from_transformer_state", "from_fused_transformer_state",
           "head_aligned", "from_head_aligned", "shard_slices",
           "shard_params", "unshard_params", "shard_pieces",
           "qkv_col_order"]

# leaves stored (in, out) by Paddle's Linear and transposed here
_LINEAR = re.compile(
    r"^(gpt\.h\.\d+\.(attn\.(qkv_proj|out_proj)|mlp\.(fc_in|fc_out))"
    r"|lm_head)\.weight$")
_BERT_LINEAR = re.compile(
    r"^(bert\.encoder\.\d+\.(attn\.(qkv_proj|out_proj)|fc_in|fc_out)"
    r"|bert\.pooler|mlm_transform|nsp_head)\.weight$")
_LLAMA_LINEAR = re.compile(
    r"^(model\.layers\.\d+\.(self_attn\.[qkvo]_proj|mlp\.(gate|up|down)_proj)"
    r"|lm_head)\.weight$")


def expected_leaves(cfg) -> Dict[str, tuple]:
    """``{name: torch shape}`` of the port's GPTForCausalLM for ``cfg``."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    out = {
        "gpt.embeddings.word_embeddings.weight": (v, h),
        "gpt.embeddings.position_embeddings.weight":
            (cfg.max_position_embeddings, h),
        "gpt.ln_f.weight": (h,),
        "gpt.ln_f.bias": (h,),
    }
    for i in range(cfg.num_layers):
        p = f"gpt.h.{i}."
        out.update({
            p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
            p + "attn.qkv_proj.weight": (3 * h, h),
            p + "attn.qkv_proj.bias": (3 * h,),
            p + "attn.out_proj.weight": (h, h),
            p + "attn.out_proj.bias": (h,),
            p + "ln_2.weight": (h,), p + "ln_2.bias": (h,),
            p + "mlp.fc_in.weight": (f, h), p + "mlp.fc_in.bias": (f,),
            p + "mlp.fc_out.weight": (h, f), p + "mlp.fc_out.bias": (h,),
        })
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = (v, h)
    return out


def from_paddle_tpu_state(state: Dict[str, np.ndarray], cfg
                          ) -> Dict[str, torch.Tensor]:
    """The JAX model's ``state_dict()`` as numpy -> the port's
    ``state_dict()`` (CPU float tensors, load with
    ``load_state_dict``)."""
    return _map_state(state, expected_leaves(cfg), _LINEAR,
                      "from_paddle_tpu_state")


def expected_bert_leaves(cfg) -> Dict[str, tuple]:
    """``{name: torch shape}`` of the port's BertForPretraining for
    ``cfg``."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    e = "bert.embeddings."
    out = {
        e + "word_embeddings.weight": (v, h),
        e + "position_embeddings.weight": (cfg.max_position_embeddings, h),
        e + "token_type_embeddings.weight": (cfg.type_vocab_size, h),
        e + "layer_norm.weight": (h,), e + "layer_norm.bias": (h,),
    }
    for i in range(cfg.num_layers):
        p = f"bert.encoder.{i}."
        out.update({
            p + "attn.qkv_proj.weight": (3 * h, h),
            p + "attn.qkv_proj.bias": (3 * h,),
            p + "attn.out_proj.weight": (h, h),
            p + "attn.out_proj.bias": (h,),
            p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
            p + "fc_in.weight": (f, h), p + "fc_in.bias": (f,),
            p + "fc_out.weight": (h, f), p + "fc_out.bias": (h,),
            p + "ln_2.weight": (h,), p + "ln_2.bias": (h,),
        })
    out.update({
        "bert.pooler.weight": (h, h), "bert.pooler.bias": (h,),
        "mlm_transform.weight": (h, h), "mlm_transform.bias": (h,),
        "mlm_ln.weight": (h,), "mlm_ln.bias": (h,),
        "nsp_head.weight": (2, h), "nsp_head.bias": (2,),
    })
    return out


def from_bert_state(state: Dict[str, np.ndarray], cfg
                    ) -> Dict[str, torch.Tensor]:
    """The JAX ``BertForPretraining``'s ``state_dict()`` as numpy -> the
    port's ``state_dict()`` (CPU float tensors, load with
    ``load_state_dict``)."""
    return _map_state(state, expected_bert_leaves(cfg), _BERT_LINEAR,
                      "from_bert_state")


def _map_state(state, want, linear, what) -> Dict[str, torch.Tensor]:
    """``state`` onto the names and torch shapes of ``want``, the leaves
    that ``linear`` matches transposed from ``(in, out)``."""
    unknown = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if unknown or missing:
        raise KeyError(f"{what}: unknown leaves {unknown}, "
                       f"missing leaves {missing}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(state[name])
        if linear.match(name):
            arr = arr.T
        if tuple(arr.shape) != shape:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(arr.shape)} after layout mapping, "
                             f"expected {shape}")
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # own copy
    return out


_TRANSFORMER_LINEAR = re.compile(
    r"(.*\.)?(q_proj|k_proj|v_proj|out_proj|linear1|linear2)\.weight$")
_FUSED_LINEAR = re.compile(
    r"(.*\.)?(qkv_weight|linear_weight|linear1_weight|linear2_weight)$")


def _map_layer_state(state, module, linear, what):
    want = {name: tuple(t.shape) for name, t in module.state_dict().items()}
    return _map_state(state, want, linear, what)


def from_transformer_state(state: Dict[str, np.ndarray], module
                           ) -> Dict[str, torch.Tensor]:
    """The JAX transformer layers' ``state_dict()`` as numpy -> the state
    of the port's ``module`` (its twin; CPU tensors, load with
    ``load_state_dict``)."""
    return _map_layer_state(state, module, _TRANSFORMER_LINEAR,
                            "from_transformer_state")


def from_fused_transformer_state(state: Dict[str, np.ndarray], module
                                 ) -> Dict[str, torch.Tensor]:
    """As :func:`from_transformer_state` for the fused layers of
    ``incubate.nn``."""
    return _map_layer_state(state, module, _FUSED_LINEAR,
                            "from_fused_transformer_state")


def expected_gpt_params(cfg) -> Dict[str, object]:
    """``{name: shape}`` of the stacked GPT training params for ``cfg``,
    nested as the pytree (``blocks`` holds the ``(L, ...)`` leaves)."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    L = cfg.num_layers
    return {
        "wte": (v, h),
        "wpe": (cfg.max_position_embeddings, h),
        "blocks": {
            "ln1_g": (L, h), "ln1_b": (L, h),
            "qkv_w": (L, h, 3 * h), "qkv_b": (L, 3 * h),
            "out_w": (L, h, h), "out_b": (L, h),
            "ln2_g": (L, h), "ln2_b": (L, h),
            "fc_in_w": (L, h, f), "fc_in_b": (L, f),
            "fc_out_w": (L, f, h), "fc_out_b": (L, h),
        },
        "lnf_g": (h,),
        "lnf_b": (h,),
    }


def from_gpt_params(params, cfg) -> Dict[str, object]:
    """The JAX trainer's params pytree (numpy leaves, e.g.
    ``jax.device_get(trainer.params)``) -> the port's nested dict of CPU
    tensors. An unknown or a missing leaf raises ``KeyError``, a wrong
    shape ``ValueError``."""
    return _map_params(params, expected_gpt_params(cfg), "from_gpt_params")


def _map_params(params, expected, what) -> Dict[str, object]:
    want = dict(flatten(expected))
    got = dict(flatten(params))
    unknown = sorted("/".join(p) for p in set(got) - set(want))
    missing = sorted("/".join(p) for p in set(want) - set(got))
    if unknown or missing:
        raise KeyError(f"{what}: unknown leaves {unknown}, "
                       f"missing leaves {missing}")
    out = []
    for path, shape in want.items():
        arr = np.array(got[path], order="C")                # own copy
        if tuple(arr.shape) != shape:
            raise ValueError(f"{what}: {'/'.join(path)} has shape "
                             f"{tuple(arr.shape)}, expected {shape}")
        out.append((path, torch.from_numpy(arr)))
    return unflatten(out)


def expected_llama_leaves(cfg) -> Dict[str, tuple]:
    """``{name: torch shape}`` of the port's LlamaForCausalLM for
    ``cfg``."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    out = {"model.embed_tokens.weight": (v, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f),
        })
    out["model.norm.weight"] = (h,)
    out["lm_head.weight"] = (v, h)
    return out


def from_llama_state(state: Dict[str, np.ndarray], cfg
                     ) -> Dict[str, torch.Tensor]:
    """The JAX ``LlamaForCausalLM.state_dict()`` as numpy -> the port's
    ``state_dict()`` (CPU float tensors, load with ``load_state_dict``);
    Paddle's ``(in, out)`` linear weights are transposed."""
    return _map_state(state, expected_llama_leaves(cfg), _LLAMA_LINEAR,
                      "from_llama_state")


def expected_llama_params(cfg) -> Dict[str, object]:
    """``{name: shape}`` of the stacked LLaMA training params for
    ``cfg`` (``llama_core.llama_init``), nested as the pytree."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    L = cfg.num_layers
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    return {
        "wte": (v, h),
        "blocks": {
            "ln1_g": (L, h),
            "q_w": (L, h, q), "k_w": (L, h, kv), "v_w": (L, h, kv),
            "o_w": (L, q, h),
            "ln2_g": (L, h),
            "gate_w": (L, h, f), "up_w": (L, h, f), "down_w": (L, f, h),
        },
        "lnf_g": (h,),
        "lm_w": (h, v),
    }


def from_llama_params(params, cfg) -> Dict[str, object]:
    """The JAX ``llama_init`` pytree (numpy leaves) -> the port's
    ``llama_core`` dict of CPU tensors; errors as ``from_gpt_params``."""
    return _map_params(params, expected_llama_params(cfg),
                       "from_llama_params")


# -- one rank's shards under a layout -----------------------------------------

_AXES = ("data", "pipe", "sharding", "expert", "sep", "model")
_QKV = ("qkv_w", "qkv_b")


def qkv_order(cfg, mp: int) -> np.ndarray:
    """Column ``c`` of the head-aligned fused qkv is column
    ``qkv_order(cfg, mp)[c]`` of the JAX layout ``[q | k | v]``: rank m's
    contiguous ``3H / mp`` columns hold its q heads, then its k heads,
    then its v heads."""
    hp = cfg.num_heads * cfg.head_dim
    w = hp // mp
    return np.concatenate([np.arange(sec * hp + m * w, sec * hp + (m + 1) * w)
                           for m in range(mp) for sec in range(3)])


def _take_last(x, idx):
    if isinstance(x, torch.Tensor):
        return x.index_select(-1, torch.as_tensor(idx, device=x.device))
    return np.take(np.asarray(x), idx, axis=-1)


def _reorder_qkv(params, cfg, mp, idx):
    if mp == 1 or "qkv_w" not in params.get("blocks", {}):
        return params
    blocks = dict(params["blocks"])
    for k in _QKV:
        blocks[k] = _take_last(blocks[k], idx)
    return dict(params, blocks=blocks)


def head_aligned(params, cfg, mp: int):
    """GPT params with ``qkv_w``/``qkv_b`` in the head-aligned column
    order for ``mp`` tensor-parallel ranks (LLaMA params unchanged)."""
    return _reorder_qkv(params, cfg, mp, qkv_order(cfg, mp))


def from_head_aligned(params, cfg, mp: int):
    """The inverse of :func:`head_aligned`."""
    return _reorder_qkv(params, cfg, mp, np.argsort(qkv_order(cfg, mp)))


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _coords(mesh_shape, rank):
    out = {}
    for a in reversed(_AXES):
        n = int(mesh_shape.get(a, 1))
        out[a] = rank % n
        rank //= n
    return out


def shard_slices(shape, spec, mesh_shape, rank) -> tuple:
    """The index of rank ``rank``'s shard of a ``shape`` leaf under
    ``spec``: per dim, its contiguous piece along the entry's axes."""
    coords = _coords(mesh_shape, rank)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        n, c = 1, 0
        for a in _entry_axes(e):
            n *= int(mesh_shape.get(a, 1))
            c = c * int(mesh_shape.get(a, 1)) + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide by {n} ({e!r}); "
                             "sanitize the specs first")
        out.append(slice(c * (dim // n), (c + 1) * (dim // n)))
    return tuple(out)


def shard_pieces(local, shape, spec, mesh_shape, rank,
                 col_order=None) -> list:
    """Rank ``rank``'s shard ``local`` of a ``shape`` leaf under ``spec``
    as ``[(index, data)]`` pieces of the global value: empty when a lower
    rank holds the same shard (it writes it), else one
    piece, or with ``col_order`` (a head-aligned qkv leaf: its column c
    is the global column ``col_order[c]``) one piece per run of
    consecutive global columns."""
    mine = shard_slices(shape, spec, mesh_shape, rank)
    if any(shard_slices(shape, spec, mesh_shape, r) == mine
           for r in range(rank)):
        return []
    if col_order is None:
        return [(mine, local)]
    a, b = mine[-1].start, mine[-1].stop
    out, c0 = [], a
    for c in range(a + 1, b + 1):
        if c == b or col_order[c] != col_order[c - 1] + 1:
            g0 = int(col_order[c0])
            out.append((mine[:-1] + (slice(g0, g0 + c - c0),),
                        local[..., c0 - a:c - a]))
            c0 = c
    return out


def qkv_col_order(path, cfg, mp: int):
    """``qkv_order`` for a GPT qkv leaf's path (``(..., "blocks",
    "qkv_w")``) at ``mp`` > 1, else None."""
    if mp == 1 or len(path) < 2 or path[-2:] not in (
            ("blocks", "qkv_w"), ("blocks", "qkv_b")):
        return None
    return qkv_order(cfg, mp)


def shard_params(params, cfg, specs, mesh_shape, rank) -> Dict[str, object]:
    """Rank ``rank``'s shards (CPU tensors, each its own copy) of the full
    stacked ``params`` under the spec tree ``specs`` and the axis sizes
    ``mesh_shape`` (GPT's qkv head-aligned first)."""
    params = head_aligned(params, cfg, int(mesh_shape.get("model", 1)))
    spec_of = dict(flatten(specs))
    out = []
    for path, leaf in flatten(params):
        arr = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        sl = shard_slices(tuple(arr.shape), spec_of[path], mesh_shape, rank)
        out.append((path, arr[sl].clone(memory_format=torch.contiguous_format)))
    return unflatten(out)


def unshard_params(shards, cfg, specs, mesh_shape) -> Dict[str, object]:
    """Every rank's shards (``shards[rank]``, a tree of tensors or
    arrays) back into the full params as numpy arrays, qkv in the JAX
    column order."""
    spec_of = dict(flatten(specs))
    world = len(shards)
    by_rank = [dict(flatten(s)) for s in shards]
    out = []
    for path, first in flatten(shards[0]):
        spec = spec_of[path]
        entries = list(spec) + [None] * (np.ndim(first) - len(spec))
        shape = tuple(d * int(np.prod([mesh_shape.get(a, 1)
                                       for a in _entry_axes(e)]))
                      for d, e in zip(np.shape(first), entries))
        full = np.empty(shape, dtype=np.asarray(
            first.detach().cpu() if isinstance(first, torch.Tensor)
            else first).dtype)
        for r in range(world):
            piece = by_rank[r][path]
            if isinstance(piece, torch.Tensor):
                piece = piece.detach().cpu().numpy()
            full[shard_slices(shape, spec, mesh_shape, r)] = piece
        out.append((path, full))
    return from_head_aligned(unflatten(out), cfg,
                             int(mesh_shape.get("model", 1)))
