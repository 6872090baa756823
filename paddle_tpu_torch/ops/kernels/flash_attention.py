"""K-BSHD: flash attention forward over the ``(B, S, H, D)`` layout.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py``
``_fwd_kernel`` (launched by ``_flash_call``), forward only: serving's
``prefill_batch`` (``generate()``) and the model's no-cache forward. A
contiguous ``(B, S, H, D)`` tensor has the bytes of ``(B, S, H*D)``, so
the kernel shares K-SEG's strided source
(``paddle_tpu_torch/csrc/flash_attention_fwd.cu``, entry
``flash_attention_fwd_bshd``) and the TPU's ``(B*H, S, D)`` transpose is
gone.

Returns ``o`` ``(B, S, H, D)`` in q's dtype and a natural-log ``lse``
``(B, S, H)`` fp32. The causal mask is top-left with ``Sq == Sk``.

What bounds it on the H100: ~4*d FLOPs per visible (query, key) pair,
operations rather than bytes; the kernel runs them on the CUDA cores in
fp32 from 64x64 shared-memory tiles and never visits tiles above the
diagonal (see K-SEG's note). Tensor cores (wgmma) are later work.

``flash_attention_bshd`` takes the plain version for CPU tensors only; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_bshd", "causal_attention_ref"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = {"K-BSHD": 0}
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_attention_ref(q, k, v, causal=True, scale=None):
    """Plain PyTorch version (mirrors ``xla_causal_attention``): one
    dense fp32 softmax over ``(B, S, H, D)``, the causal mask aligned to
    the end (``Sk > Sq`` reads as a cache). Returns ``(o, lse)``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = (q * scale).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(idx_k <= idx_q), _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, H, Sq)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, lse.transpose(1, 2).contiguous()


def flash_attention_bshd(q, k, v, causal=True, scale=None):
    """Attention over ``(B, S, H, D)``: the plain version for CPU
    tensors, the K-BSHD kernel for CUDA tensors. Returns ``(o, lse)``."""
    if q.device.type == "cpu":
        return causal_attention_ref(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale)


def _launch(q, k, v, causal, scale):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bshd: no kernel for device "
                         f"{q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention_bshd: q, k, v must share one "
                         "(B, S, H, D) shape (the causal mask is top-left, "
                         "Sq == Sk)")
    b, s, h, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash_attention_bshd: head_dim {d} not in "
                         "(64, 128), the kernel's instantiations")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_bshd: q, k, v dtypes differ")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention_bshd: tensors on different "
                         "devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_bshd: tensors must be contiguous")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, d, float(scale), int(bool(causal)),
            _build.dtype_code(q.dtype), stream)
    _build.check(rc, "flash_attention_fwd_bshd")
    LAUNCHES["K-BSHD"] += 1
    return o, lse
