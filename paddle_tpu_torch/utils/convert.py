"""Carry weights from the JAX package's GPT to the port's.

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

Every leaf must be accounted for: an unknown or a missing name raises.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .tree import flatten, unflatten

__all__ = ["from_paddle_tpu_state", "expected_leaves", "from_gpt_params",
           "expected_gpt_params"]

# leaves stored (in, out) by Paddle's Linear and transposed here
_LINEAR = re.compile(
    r"^(gpt\.h\.\d+\.(attn\.(qkv_proj|out_proj)|mlp\.(fc_in|fc_out))"
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
    want = expected_leaves(cfg)
    unknown = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if unknown or missing:
        raise KeyError(f"from_paddle_tpu_state: unknown leaves {unknown}, "
                       f"missing leaves {missing}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(state[name])
        if _LINEAR.match(name):
            arr = arr.T
        if tuple(arr.shape) != shape:
            raise ValueError(f"from_paddle_tpu_state: {name} has shape "
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
    want = dict(flatten(expected_gpt_params(cfg)))
    got = dict(flatten(params))
    unknown = sorted("/".join(p) for p in set(got) - set(want))
    missing = sorted("/".join(p) for p in set(want) - set(got))
    if unknown or missing:
        raise KeyError(f"from_gpt_params: unknown leaves {unknown}, "
                       f"missing leaves {missing}")
    out = []
    for path, shape in want.items():
        arr = np.array(got[path], order="C")                # own copy
        if tuple(arr.shape) != shape:
            raise ValueError(f"from_gpt_params: {'/'.join(path)} has shape "
                             f"{tuple(arr.shape)}, expected {shape}")
        out.append((path, torch.from_numpy(arr)))
    return unflatten(out)
