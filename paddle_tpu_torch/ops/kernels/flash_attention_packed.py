"""K-SEG: segmented causal flash forward over the packed layout.

Replaces the Pallas TPU kernel
``paddle_tpu/ops/pallas/flash_attention_packed.py`` ``_fwd_kernel_seg``
(launched by ``_fwd_call_seg``), forward only: serving's
``prefill_packed`` packs every admitted request into one ``(1, T, NH*D)``
row with segment ids, and position i attends j only where
``seg[i] == seg[j]`` and ``j <= i``. Pad id -1 attends only to pad. The
CUDA source, shared with K-BSHD, is
``paddle_tpu_torch/csrc/flash_attention_fwd.cu``.

Returns ``o`` ``(B, S, NH*D)`` in q's dtype and a natural-log ``lse``
``(B, S, NH)`` fp32 (the backward kernels of a later training slice need
it).

What bounds it on the H100: the ~4*d FLOPs of every (query, key) pair
that shares a segment, not bytes. This first kernel runs them on the
CUDA cores in fp32 from shared-memory tiles (64x64, each thread a 4x4
block of scores); it never visits causal tiles above the diagonal and
skips, before loading K/V, every tile in which no pair shares a segment,
so a packed batch costs about the sum of its requests' own triangles.
Tensor cores (wgmma) are later work.

``flash_attention_packed_segmented`` takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_packed_segmented", "segment_attention_ref"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def segment_attention_ref(q, k, v, segment_ids, nh, scale=None):
    """Plain PyTorch version (mirrors ``xla_segment_attention`` for
    causal self-attention): one dense segment-masked fp32 softmax over
    the packed ``(B, S, NH*D)`` layout. Returns ``(o, lse)``; ``lse`` is
    the natural-log row normaliser ``(B, S, NH)``."""
    b, s, hp = q.shape
    d = hp // nh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    def unpack(x):
        return x.reshape(b, s, nh, d)

    qf = (unpack(q) * scale).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, unpack(k).float())
    seg = segment_ids.long()
    idx = torch.arange(s, device=q.device)
    ok = ((seg[:, :, None] == seg[:, None, :])
          & (idx[None, :] <= idx[:, None])[None])[:, None]
    logits = logits.masked_fill(~ok, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, nh, S)
    p = torch.softmax(logits, dim=-1).masked_fill(~ok, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), unpack(v))
    return o.reshape(b, s, hp), lse.transpose(1, 2).contiguous()


def flash_attention_packed_segmented(q, k, v, segment_ids, nh,
                                     scale=None):
    """Segment-masked causal self-attention over ``(B, S, NH*D)``: the
    plain version for CPU tensors, the K-SEG kernel for CUDA tensors.
    Returns ``(o, lse)``."""
    if q.device.type == "cpu":
        return segment_attention_ref(q, k, v, segment_ids, nh, scale=scale)
    return _launch(q, k, v, segment_ids, nh, scale)


def _launch(q, k, v, segment_ids, nh, scale):
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed_segmented: no kernel for "
                         f"device {q.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention_packed_segmented: q, k, v must "
                         "share one (B, S, NH*D) shape")
    b, s, hp = q.shape
    if hp % nh:
        raise ValueError(f"flash_attention_packed_segmented: width {hp} "
                         f"is not {nh} whole heads")
    d = hp // nh
    if d not in (64, 128):
        raise ValueError(f"flash_attention_packed_segmented: head_dim {d} "
                         "not in (64, 128), the kernel's instantiations")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_packed_segmented: q, k, v dtypes "
                        "differ")
    if segment_ids.dtype != torch.int32 or tuple(segment_ids.shape) != (b, s):
        raise ValueError("flash_attention_packed_segmented: segment_ids "
                         "(B, S) int32 expected")
    ts = (q, k, v, segment_ids)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention_packed_segmented: tensors on "
                         "different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_packed_segmented: tensors must "
                         "be contiguous")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, s, nh), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd_seg(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, s, nh, d, float(scale), 1,
            _build.dtype_code(q.dtype), stream)
    _build.check(rc, "flash_attention_fwd_seg")
    LAUNCHES += 1
    return o, lse
