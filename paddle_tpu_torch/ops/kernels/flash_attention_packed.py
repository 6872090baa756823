"""Flash attention over the packed ``(B, S, NH*D)`` layout: six kernels.

Each replaces a Pallas TPU kernel of
``paddle_tpu/ops/pallas/flash_attention_packed.py``:

=======  ==============================  =====================================
kernel   wrapper                         replaces (launched by)
=======  ==============================  =====================================
K-SEG    ``seg_fwd`` (``flash_attention_  ``_fwd_kernel_seg`` (``_fwd_call_seg``)
         packed_segmented``)
K-PACK   ``packed_fwd``                  ``_fwd_kernel`` (``_fwd_call``)
K-DQ     ``packed_dq``                   ``_dq_kernel`` (``_dq_call``)
K-DKV    ``packed_dkv``                  ``_dkv_kernel`` (``_dkv_call``)
K-SDQ    ``seg_dq``                      ``_dq_kernel_seg`` (``_dq_call_seg``)
K-SDKV   ``seg_dkv``                     ``_dkv_kernel_seg``
                                         (``_dkv_call_seg``)
=======  ==============================  =====================================

Segment ids: position i attends j only where ``seg[i] == seg[j]`` and
``j <= i``, and pad id -1 attends only to pad. K-SEG is serving's
``prefill_packed`` (every admitted request packed into one
``(1, T, NH*D)`` row) and the packed-sequence trainer's forward, which
hands q, k, v over as column slices of the fused qkv. K-PACK, K-DQ and
K-DKV are the
training path, tied together by ``FlashAttentionPacked``
(``flash_attention_packed``); K-SEG, K-SDQ and K-SDKV are the packed-
sequence trainer's, tied together by ``FlashAttentionPackedSeg``
(``flash_attention_packed_seg``). Each backward computes
``delta = sum_d(dO * O)`` per head in fp32 and then launches its dQ and
dK/dV kernels. The forward sources are ``paddle_tpu_torch/csrc/
flash_attention_fwd.cu`` (K-SEG, K-PACK, shared with K-BSHD), the
backward ``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` (shared with
K-BDQ and K-BDKV).

Layouts are the JAX package's: q, k, v, o and the gradients are
``(B, S, NH*D)``; ``lse`` (the forward's natural-log row normaliser) and
``delta`` are ``(B, Sq, NH)`` fp32. Causal attention is top-left with
``Sq == Sk``; full attention takes ``Sq != Sk`` (ring attention's
off-diagonal blocks). q, k and v may be column slices of the fused qkv
projection: the kernels take a row stride per operand, so those slices
are read in place; only a tensor whose last dim is not contiguous, or
whose batches are not its rows back to back, is copied first.

What bounds them on the H100: the ~4*d (forward), ~6*d (dQ) and ~8*d
(dK/dV) FLOPs of every visible (query, key) pair, not bytes. In bf16
every product runs on the tensor cores as wgmma, with tiles brought in
by TMA through a 2-stage ring: the forward (K-PACK, K-SEG) over 128-row
q-blocks with P kept in registers; dQ (K-DQ, K-SDQ) over 64-row
q-blocks with dS in registers; dK/dV (K-DKV, K-SDKV) over 64-key blocks
in the transposed space, P^T and dS^T in registers. Their operands need
a 16-byte-aligned base and row stride, and ``_rows`` copies any that
lack them. In fp32 the kernels run on the CUDA cores from 64x64
shared-memory tiles (each thread a 4x4 block of scores). All of them
never visit causal tiles above the diagonal, skip tiles where no pair
shares a segment, and mask ragged S in the kernel.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_packed_segmented", "segment_attention_ref",
           "packed_attention_ref", "packed_dq_ref", "packed_dkv_ref",
           "segment_dq_ref", "segment_dkv_ref", "packed_fwd", "packed_dq",
           "packed_dkv", "seg_fwd", "seg_dq", "seg_dkv",
           "FlashAttentionPacked", "flash_attention_packed",
           "FlashAttentionPackedSeg", "flash_attention_packed_seg"]

# kernel launches since the last reset (each wrapper adds one to its
# kernel's count per launch)
LAUNCHES = {"K-SEG": 0, "K-PACK": 0, "K-DQ": 0, "K-DKV": 0, "K-SDQ": 0,
            "K-SDKV": 0}
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


# -- training: K-PACK, K-DQ, K-DKV and K-SEG, K-SDQ, K-SDKV ------------------

def _unpack(x, nh):
    b, s, hp = x.shape
    return x.reshape(b, s, nh, hp // nh)


def _scores(q, k, nh, causal, scale, seg=None):
    """fp32 ``scale * q.k`` as ``(B, NH, Sq, Sk)`` and the visibility
    mask: top-left causal or all-true, and with ``seg`` ``(B, S)`` only
    pairs of one segment id."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _unpack(q, nh).float() * scale,
                          _unpack(k, nh).float())
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None]
        idx_k = torch.arange(sk, device=q.device)[None, :]
        ok = idx_k <= idx_q
    else:
        ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if seg is not None:
        seg = seg.long()
        ok = (ok[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    return logits.masked_fill(~ok, _NEG_INF), ok


def _scale_of(q, nh, scale):
    return scale if scale is not None else 1.0 / ((q.shape[-1] // nh) ** 0.5)


def packed_attention_ref(q, k, v, nh, causal=True, scale=None):
    """Plain PyTorch K-PACK (mirrors ``_fwd_call``): one dense fp32
    softmax. Returns ``o`` ``(B, Sq, NH*D)`` in q's dtype and ``lse``
    ``(B, Sq, NH)`` fp32."""
    scale = _scale_of(q, nh, scale)
    logits, _ = _scores(q, k, nh, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, NH, Sq)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, _unpack(v, nh).float())
    return (o.reshape(q.shape).to(q.dtype),
            lse.transpose(1, 2).contiguous())


def _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg):
    logits, ok = _scores(q, k, nh, causal, scale, seg)
    p = torch.exp(logits - lse.float().transpose(1, 2)[..., None])
    p = p.masked_fill(~ok, 0.0)       # exactly 0 on masked entries
    dp = torch.einsum("bqhd,bkhd->bhqk", _unpack(do, nh).float(),
                      _unpack(v, nh).float())
    ds = p * (dp - delta.float().transpose(1, 2)[..., None])
    return p, ds


def _dq_ref(q, k, v, do, lse, delta, nh, causal, scale, seg):
    scale = _scale_of(q, nh, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _unpack(k, nh).float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def _dkv_ref(q, k, v, do, lse, delta, nh, causal, scale, seg):
    scale = _scale_of(q, nh, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _unpack(q, nh).float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _unpack(do, nh).float())
    return (dk.reshape(k.shape).to(q.dtype),
            dv.reshape(v.shape).to(q.dtype))


def packed_dq_ref(q, k, v, do, lse, delta, nh, causal=True, scale=None):
    """Plain PyTorch K-DQ (mirrors ``_dq_call``): ``dq = scale * ds.k``
    with ``ds = p * (do.v - delta)``, ``p = exp(scale * q.k - lse)``.
    ``lse``, ``delta``: ``(B, Sq, NH)``. Returns dq in q's dtype."""
    return _dq_ref(q, k, v, do, lse, delta, nh, causal, scale, None)


def packed_dkv_ref(q, k, v, do, lse, delta, nh, causal=True, scale=None):
    """Plain PyTorch K-DKV (mirrors ``_dkv_call``, with lse and delta
    untransposed ``(B, Sq, NH)``): ``dk = scale * ds^T.q``,
    ``dv = p^T.do``. Returns ``(dk, dv)`` in q's dtype."""
    return _dkv_ref(q, k, v, do, lse, delta, nh, causal, scale, None)


def segment_dq_ref(q, k, v, do, lse, delta, segment_ids, nh, scale=None):
    """Plain PyTorch K-SDQ (mirrors ``_dq_call_seg`` for causal
    self-attention): ``packed_dq_ref`` where a pair is visible only
    within one segment id, with p exactly 0 on every masked entry."""
    return _dq_ref(q, k, v, do, lse, delta, nh, True, scale, segment_ids)


def segment_dkv_ref(q, k, v, do, lse, delta, segment_ids, nh, scale=None):
    """Plain PyTorch K-SDKV (mirrors ``_dkv_call_seg``, with lse and
    delta untransposed ``(B, S, NH)``). Returns ``(dk, dv)``."""
    return _dkv_ref(q, k, v, do, lse, delta, nh, True, scale, segment_ids)


def packed_fwd(q, k, v, nh, causal=True, scale=None):
    """Packed flash forward: the plain version for CPU tensors, K-PACK
    for CUDA tensors. Returns ``(o, lse)``."""
    if q.device.type == "cpu":
        return packed_attention_ref(q, k, v, nh, causal=causal, scale=scale)
    out = _launch_fwd("packed_fwd", q, k, v, nh, causal, scale)
    LAUNCHES["K-PACK"] += 1
    return out


def packed_dq(q, k, v, do, lse, delta, nh, causal=True, scale=None):
    """dQ from the forward's lse and ``delta = sum_d(do * o)``: the plain
    version for CPU tensors, K-DQ for CUDA tensors."""
    if q.device.type == "cpu":
        return packed_dq_ref(q, k, v, do, lse, delta, nh, causal=causal,
                             scale=scale)
    dq = _launch_bwd("packed_dq", "dq", q, k, v, do, lse, delta, nh, causal,
                     scale)
    LAUNCHES["K-DQ"] += 1
    return dq


def packed_dkv(q, k, v, do, lse, delta, nh, causal=True, scale=None):
    """dK, dV from the forward's lse and delta: the plain version for
    CPU tensors, K-DKV for CUDA tensors. Returns ``(dk, dv)``."""
    if q.device.type == "cpu":
        return packed_dkv_ref(q, k, v, do, lse, delta, nh, causal=causal,
                              scale=scale)
    dkv = _launch_bwd("packed_dkv", "dkv", q, k, v, do, lse, delta, nh,
                      causal, scale)
    LAUNCHES["K-DKV"] += 1
    return dkv


def seg_fwd(q, k, v, segment_ids, nh, scale=None):
    """Segment-masked causal forward over ``(B, S, NH*D)`` whose q, k, v
    may be column slices of the fused qkv: the plain version for CPU
    tensors, K-SEG for CUDA tensors. Returns ``(o, lse)``."""
    if q.device.type == "cpu":
        return segment_attention_ref(q, k, v, segment_ids, nh, scale=scale)
    out = _launch_fwd("seg_fwd", q, k, v, nh, True, scale, segment_ids)
    LAUNCHES["K-SEG"] += 1
    return out


# the JAX package's name for the forward
flash_attention_packed_segmented = seg_fwd


def seg_dq(q, k, v, do, lse, delta, segment_ids, nh, scale=None):
    """Segmented dQ: the plain version for CPU tensors, K-SDQ for CUDA
    tensors."""
    if q.device.type == "cpu":
        return segment_dq_ref(q, k, v, do, lse, delta, segment_ids, nh,
                              scale=scale)
    dq = _launch_bwd("seg_dq", "dq", q, k, v, do, lse, delta, nh, True,
                     scale, segment_ids)
    LAUNCHES["K-SDQ"] += 1
    return dq


def seg_dkv(q, k, v, do, lse, delta, segment_ids, nh, scale=None):
    """Segmented dK, dV: the plain version for CPU tensors, K-SDKV for
    CUDA tensors. Returns ``(dk, dv)``."""
    if q.device.type == "cpu":
        return segment_dkv_ref(q, k, v, do, lse, delta, segment_ids, nh,
                               scale=scale)
    dkv = _launch_bwd("seg_dkv", "dkv", q, k, v, do, lse, delta, nh, True,
                      scale, segment_ids)
    LAUNCHES["K-SDKV"] += 1
    return dkv


def _rows(t, what):
    """``(tensor, row stride)`` in the layout the kernels read: unit
    stride along the last dim, a batch's rows back to back, and a base
    address and row stride that are multiples of 16 bytes (the bf16
    kernels' TMA copies take nothing else). Column slices of a fused qkv
    and the ``unbind`` views of ``(B, S, 3, H, D)`` pass as they are;
    anything else is copied into a fresh dense tensor."""
    b, s, w = t.shape
    rs = t.stride(1) if s > 1 else (t.stride(0) if b > 1 else w)
    if (t.stride(2) != 1 or rs < w or (b > 1 and t.stride(0) != s * rs)
            or t.data_ptr() % 16 or rs * t.element_size() % 16):
        t, rs = t.clone(memory_format=torch.contiguous_format), w
    if rs >= 2 ** 31:
        raise ValueError(f"{what}: row stride {rs} exceeds int32")
    return t, rs


def _check(what, q, k, v, nh, causal, extra=(), seg=None):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{what}: q (B, Sq, NH*D) and k, v (B, Sk, NH*D) "
                         "expected")
    b, sq, hp = q.shape
    if k.shape[0] != b or k.shape[2] != hp:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if causal and k.shape[1] != sq:
        raise ValueError(f"{what}: causal attention needs Sq == Sk "
                         f"({sq} vs {k.shape[1]})")
    if hp % nh:
        raise ValueError(f"{what}: width {hp} is not {nh} whole heads")
    d = hp // nh
    if d not in (64, 128):
        raise ValueError(f"{what}: head_dim {d} not in (64, 128), the "
                         "kernels' instantiations")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ")
    if seg is not None:
        if (seg.dtype != torch.int32 or tuple(seg.shape) != (b, sq)
                or not seg.is_contiguous()):
            raise ValueError(f"{what}: segment_ids must be contiguous "
                             f"(B, S) = {(b, sq)} int32")
        extra = (*extra, seg)
    if any(t.device != q.device for t in (k, v, *extra)):
        raise ValueError(f"{what}: tensors on different devices")
    return d


def _launch_fwd(what, q, k, v, nh, causal, scale, seg=None):
    """One forward launch (K-PACK, or K-SEG with ``seg``); the caller
    counts it. Returns ``(o, lse)``."""
    d = _check(what, q, k, v, nh, causal, seg=seg)
    b, sq, hp = q.shape
    sk = k.shape[1]
    (q, q_rs), (k, k_rs), (v, v_rs) = (_rows(t, what) for t in (q, k, v))
    scale = _scale_of(q, nh, scale)
    o = torch.empty((b, sq, hp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, nh), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    code = _build.dtype_code(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if seg is None:
            entry = "flash_attention_fwd_packed"
            rc = lib.flash_attention_fwd_packed(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, sq, sk, nh, d, q_rs, k_rs, v_rs,
                float(scale), int(bool(causal)), code, stream)
        else:
            entry = "flash_attention_fwd_packed_seg"
            rc = lib.flash_attention_fwd_packed_seg(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, sq, nh, d, q_rs, k_rs, v_rs,
                float(scale), code, stream)
    _build.check(rc, entry)
    return o, lse


def _launch_bwd(what, kind, q, k, v, do, lse, delta, nh, causal, scale,
                seg=None):
    """One backward launch; the caller counts it. ``kind`` ``"dq"``
    launches a dQ kernel and returns dq, ``"dkv"`` a dK/dV kernel and
    returns ``(dk, dv)``; ``seg`` selects the segmented entries."""
    d = _check(what, q, k, v, nh, causal, extra=(do, lse, delta), seg=seg)
    b, sq, hp = q.shape
    sk = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do must match q's shape and dtype")
    for t, tn in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, sq, nh)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {tn} must be contiguous "
                             f"(B, Sq, NH) = {(b, sq, nh)} float32")
    (q, q_rs), (k, k_rs), (v, v_rs), (do, do_rs) = (
        _rows(t, what) for t in (q, k, v, do))
    scale = _scale_of(q, nh, scale)
    want_dq = kind == "dq"
    if want_dq:
        outs = (torch.empty((b, sq, hp), dtype=q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((b, sk, hp), dtype=q.dtype,
                                 device=q.device) for _ in range(2))
    entry = "flash_attention_bwd_" + kind
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()]
    if seg is None:
        dims = (b, sq, sk, nh, d, q_rs, k_rs, v_rs, do_rs, float(scale),
                int(bool(causal)))
    else:
        entry += "_seg"
        ptrs.append(seg.data_ptr())
        dims = (b, sq, nh, d, q_rs, k_rs, v_rs, do_rs, float(scale))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*ptrs, *(t.data_ptr() for t in outs),
                                 *dims, _build.dtype_code(q.dtype), stream)
    _build.check(rc, entry)
    return outs[0] if want_dq else outs


def _delta(do, o, nh):
    """``sum_d(do * o)`` per head in fp32, ``(B, S, NH)``."""
    return (do.float() * o.float()).reshape(*o.shape[:2], nh, -1).sum(-1)


class FlashAttentionPacked(torch.autograd.Function):
    """Packed flash attention with its backward (mirrors the JAX
    package's ``_flash_packed`` custom_vjp): the forward runs K-PACK and
    saves ``(q, k, v, o, lse)``; the backward computes ``delta`` per head
    in fp32 and runs K-DQ and K-DKV. On CPU tensors each step is its
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, nh, causal, scale):
        o, lse = packed_fwd(q, k, v, nh, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (nh, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        nh, causal, scale = ctx.attn
        delta = _delta(do, o, nh)
        dq = packed_dq(q, k, v, do, lse, delta, nh, causal=causal,
                       scale=scale)
        dk, dv = packed_dkv(q, k, v, do, lse, delta, nh, causal=causal,
                            scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_packed(q, k, v, nh, causal=True, scale=None):
    """Differentiable flash attention over ``(B, S, NH*D)`` (the JAX
    package's ``flash_attention_packed``, any S): returns ``o``."""
    if q.shape[-1] % nh:
        raise ValueError(f"hidden {q.shape[-1]} not divisible by num_heads "
                         f"{nh}")
    scale = _scale_of(q, nh, scale)
    return FlashAttentionPacked.apply(q, k, v, nh, causal, scale)


class FlashAttentionPackedSeg(torch.autograd.Function):
    """Segment-masked causal flash attention with its backward (mirrors
    the JAX package's ``_flash_packed_seg`` custom_vjp for self-attention):
    the forward runs K-SEG and saves ``(q, k, v, seg, o, lse)``; the
    backward computes ``delta`` per head in fp32 and runs K-SDQ and
    K-SDKV. The ids take no gradient. On CPU tensors each step is its
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, nh, scale):
        o, lse = seg_fwd(q, k, v, segment_ids, nh, scale=scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.attn = (nh, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        nh, scale = ctx.attn
        delta = _delta(do, o, nh)
        dq = seg_dq(q, k, v, do, lse, delta, seg, nh, scale=scale)
        dk, dv = seg_dkv(q, k, v, do, lse, delta, seg, nh, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_packed_seg(q, k, v, segment_ids, nh, scale=None):
    """Differentiable segment-masked causal self-attention over
    ``(B, S, NH*D)`` (the JAX package's
    ``flash_attention_packed_segmented`` with ``segment_ids_k=None``,
    causal): returns ``o``. q, k, v may be column slices of the fused
    qkv; ``segment_ids`` ``(B, S)`` is taken as int32."""
    if q.shape[-1] % nh:
        raise ValueError(f"hidden {q.shape[-1]} not divisible by num_heads "
                         f"{nh}")
    if tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != "
                         f"batch/seq {tuple(q.shape[:2])}")
    seg = segment_ids.to(torch.int32).contiguous()
    scale = _scale_of(q, nh, scale)
    return FlashAttentionPackedSeg.apply(q, k, v, seg, nh, scale)
