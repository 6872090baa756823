"""Carry weights from the JAX package's GPT and LLaMA to the port's.

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
(same names, same ``(in, out)`` layout).

Every leaf must be accounted for: an unknown or a missing name raises.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .tree import flatten, unflatten

__all__ = ["from_paddle_tpu_state", "expected_leaves", "from_gpt_params",
           "expected_gpt_params", "from_llama_state", "expected_llama_leaves",
           "from_llama_params", "expected_llama_params"]

# leaves stored (in, out) by Paddle's Linear and transposed here
_LINEAR = re.compile(
    r"^(gpt\.h\.\d+\.(attn\.(qkv_proj|out_proj)|mlp\.(fc_in|fc_out))"
    r"|lm_head)\.weight$")
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
