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

Segment ids: query i attends key j only where ``seg_q[i] == seg_k[j]``
(and ``j <= i`` when causal), and pad id -1 attends only to pad; without
``segment_ids_k`` the keys carry the queries' ids. Causal attention takes
one id array (self-attention, ``Sq == Sk``); full attention also takes
distinct key-side ids and ``Sq != Sk`` (varlen attention over two
``cu_seqlens``; BERT's padding mask, query ids 0 and key ids 0 or -1).
Causal attention with distinct key-side ids raises, as the TPU kernel
does. A query row that sees no key gives ``o = 0`` and
``lse = EMPTY_LSE`` (``-1e30 / log2 e``, the Pallas kernel's value).
K-SEG is serving's
``prefill_packed`` (every admitted request packed into one
``(1, T, NH*D)`` row) and the packed-sequence trainer's forward, which
hands q, k, v over as column slices of the fused qkv. K-PACK, K-DQ and
K-DKV are the training path (``flash_attention_packed``); K-SEG, K-SDQ
and K-SDKV are the packed-sequence trainer's
(``flash_attention_packed_seg``), tied together by
``FlashAttentionPacked`` and ``FlashAttentionPackedSeg``. Each forward
is an operator, ``paddle_tpu_torch::packed_fwd`` and
``paddle_tpu_torch::seg_fwd``, whose outputs o and lse a remat policy
can save (``OUTPUT_NAMES``, the JAX package's ``attn_out_kernel`` and
``attn_lse``). Each backward computes
``delta = sum_d(dO * O)`` per head in fp32 and then launches its dQ and
dK/dV kernels. The forward sources are ``paddle_tpu_torch/csrc/
flash_fwd.cuh`` (K-SEG, K-PACK, shared with K-BSHD), the
backward ``paddle_tpu_torch/csrc/flash_bwd.cuh`` (shared with
K-BDQ and K-BDKV).

Layouts are the JAX package's: q, k, v, o and the gradients are
``(B, S, NH*D)``; ``lse`` (the forward's natural-log row normaliser) and
``delta`` are ``(B, Sq, NH)`` fp32; segment ids ``(B, Sq)`` and
``(B, Sk)`` int32. Causal attention is top-left with ``Sq == Sk``; full
attention takes ``Sq != Sk`` (ring attention's off-diagonal blocks,
varlen attention). q, k and v may be column slices of the fused qkv
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

Attention dropout and additive masks (``csrc/philox.cuh``): the forward
and backward kernels take ``dropout_p`` with ``rng = (seed, offset)``,
whose Philox keep bits ``philox.keep_mask`` rebuilds bit for bit, and,
without segment ids, ``bias`` (broadcast to ``(B, NH, Sq, Sk)``, fp32,
read at its strides, never materialised), added to the scaled scores.
The plain versions take the same arguments and, for the tests, an
explicit ``keep`` mask in place of the Philox bits. A bias entry below
``BIAS_FLOOR`` counts as it (a row masked everywhere stays uniform, as in
the JAX package's dense softmax); the kernels give a mask no gradient,
and one with ``requires_grad`` raises off the CPU (on the CPU autograd
runs through the plain versions). ``VARIANTS`` counts the launches made with a
feature (``"K-SEG+drop"``, ``"K-BSHD+bias+drop"``, ...) beside
``LAUNCHES``.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, philox

__all__ = ["flash_attention_packed_segmented", "segment_attention_ref",
           "cu_seqlens_to_segment_ids", "EMPTY_LSE",
           "packed_attention_ref", "packed_dq_ref", "packed_dkv_ref",
           "segment_dq_ref", "segment_dkv_ref", "packed_fwd", "packed_dq",
           "packed_dkv", "seg_fwd", "seg_dq", "seg_dkv",
           "FlashAttentionPacked", "flash_attention_packed",
           "FlashAttentionPackedSeg", "flash_attention_packed_seg",
           "OUTPUT_NAMES", "FORWARD_OPS", "PLAIN_CALLS", "VARIANTS",
           "BIAS_FLOOR"]

# kernel launches since the last reset (each wrapper adds one to its
# kernel's count per launch)
LAUNCHES = {"K-SEG": 0, "K-PACK": 0, "K-DQ": 0, "K-DKV": 0, "K-SDQ": 0,
            "K-SDKV": 0}
# launches made with dropout or a bias, by variant ("K-SEG+drop",
# "K-BSHD+bias", "K-BDQ+bias+drop", ...), of this module's kernels and of
# ``flash_attention``'s
VARIANTS: dict = {}
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the lse of a row that sees no key: the kernels' (and the Pallas
# kernel's) -1e30 sentinel in log2 units, over log2 e in fp32
EMPTY_LSE = float(torch.tensor(-1e30) / torch.tensor(1.4426950408889634))
# the least bias the kernels add: -1e29 in log2 units, over log2 e
BIAS_FLOOR = float(torch.tensor(-1e29) / torch.tensor(1.4426950408889634))


def _count(launches, name, bias, dropout_p) -> None:
    """One launch of ``name``: its count, and its variant's with a
    feature."""
    launches[name] += 1
    tag = name + ("+bias" if bias is not None else "") + (
        "+drop" if dropout_p else "")
    if tag != name:
        VARIANTS[tag] = VARIANTS.get(tag, 0) + 1


def keep_of(keep, dropout_p, rng, shape, device):
    """The plain versions' keep mask: ``keep`` when given (the tests'
    bits), else the kernels' Philox bits of ``rng``; None without
    dropout."""
    if not dropout_p:
        return None
    if keep is not None:
        return keep
    if rng is None:
        raise ValueError("attention dropout needs rng=(seed, offset)")
    return philox.keep_mask(rng, dropout_p, shape, device)


def _dropped(p, keep, dropout_p):
    """``keep * p / (1 - dropout_p)`` (the JAX package's
    ``where(keep, p / (1 - dropout_p), 0)``); p without dropout."""
    return p if keep is None else torch.where(keep, p / (1.0 - dropout_p),
                                              torch.zeros_like(p))


def cu_seqlens_to_segment_ids(cu_seqlens, total_len: int):
    """Cumulative sequence starts -> per-token segment ids (the JAX
    package's function of the same name). ``cu_seqlens`` int ``(nseq +
    1,)`` with ``cu[0] == 0``; token t belongs to sequence i iff
    ``cu[i] <= t < cu[i+1]``; tokens at or past ``cu[-1]`` get the pad
    id -1. Returns ``(total_len,)`` int32 on ``cu_seqlens``' device."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total_len, dtype=torch.int32, device=cu.device)
    ids = torch.searchsorted(cu[1:].contiguous(), pos, right=True)
    return torch.where(pos < cu[-1], ids.to(torch.int32),
                       torch.full_like(pos, -1))


def segment_attention_ref(q, k, v, segment_ids, nh, scale=None,
                          segment_ids_k=None, causal=True, dropout_p=0.0,
                          rng=None, keep=None):
    """Plain PyTorch K-SEG (mirrors ``_fwd_call_seg``): one dense
    segment-masked fp32 softmax over the packed ``(B, S, NH*D)`` layout,
    query ids ``segment_ids`` ``(B, Sq)`` against key ids
    ``segment_ids_k`` ``(B, Sk)`` (default: the query ids). Returns
    ``(o, lse)``; ``lse`` is the natural-log row normaliser
    ``(B, Sq, NH)``, ``EMPTY_LSE`` on a row that sees no key (whose o is
    0). ``dropout_p`` drops the masked probabilities by ``keep`` or the
    Philox bits of ``rng`` (``xla_segment_attention``'s dropout)."""
    scale = _scale_of(q, nh, scale)
    logits, ok = _scores(q, k, nh, causal, scale, segment_ids,
                         segment_ids_k)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, nh, Sq)
    lse = lse.masked_fill(~ok.any(-1), EMPTY_LSE)
    p = torch.softmax(logits, dim=-1).masked_fill(~ok, 0.0)
    keep = keep_of(keep, dropout_p, rng, logits.shape, q.device)
    p = _dropped(p, keep, dropout_p)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), _unpack(v, nh))
    return o.reshape(q.shape), lse.transpose(1, 2).contiguous()


# -- training: K-PACK, K-DQ, K-DKV and K-SEG, K-SDQ, K-SDKV ------------------

def _unpack(x, nh):
    b, s, hp = x.shape
    return x.reshape(b, s, nh, hp // nh)


def _scores(q, k, nh, causal, scale, seg=None, seg_k=None, bias=None):
    """fp32 ``scale * q.k`` (plus ``bias``, broadcast to ``(B, NH, Sq,
    Sk)`` and floored at ``BIAS_FLOOR``) as ``(B, NH, Sq, Sk)`` and the
    visibility mask: top-left causal or all-true, and with ``seg``
    ``(B, Sq)`` only pairs whose query id equals the key's (``seg_k``
    ``(B, Sk)``, default ``seg``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _unpack(q, nh).float() * scale,
                          _unpack(k, nh).float())
    if bias is not None:
        logits = logits + bias.float().clamp(min=BIAS_FLOOR)
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None]
        idx_k = torch.arange(sk, device=q.device)[None, :]
        ok = idx_k <= idx_q
    else:
        ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if seg is not None:
        seg_k = (seg if seg_k is None else seg_k).long()
        ok = (ok[None] & (seg.long()[:, :, None] == seg_k[:, None, :])
              )[:, None]
    return logits.masked_fill(~ok, _NEG_INF), ok


def _scale_of(q, nh, scale):
    return scale if scale is not None else 1.0 / ((q.shape[-1] // nh) ** 0.5)


def packed_attention_ref(q, k, v, nh, causal=True, scale=None, bias=None,
                         dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch K-PACK (mirrors ``_fwd_call``): one dense fp32
    softmax, with ``bias`` added to the scores and ``dropout_p`` dropping
    the probabilities by ``keep`` or the Philox bits of ``rng`` (lse is
    the undropped one). Returns ``o`` ``(B, Sq, NH*D)`` in q's dtype and
    ``lse`` ``(B, Sq, NH)`` fp32."""
    scale = _scale_of(q, nh, scale)
    logits, _ = _scores(q, k, nh, causal, scale, bias=bias)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, NH, Sq)
    p = torch.exp(logits - lse[..., None])
    p = _dropped(p, keep_of(keep, dropout_p, rng, logits.shape, q.device),
                 dropout_p)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _unpack(v, nh).float())
    return (o.reshape(q.shape).to(q.dtype),
            lse.transpose(1, 2).contiguous())


def _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg,
                  seg_k=None, bias=None, dropout_p=0.0, rng=None, keep=None):
    """The kept probabilities (dV's) and dS: with dropout (FlashAttention-2's
    backward) ``ds = p * (z * dp / (1 - dropout_p) - delta)``, z the keep
    bits."""
    logits, ok = _scores(q, k, nh, causal, scale, seg, seg_k, bias)
    p = torch.exp(logits - lse.float().transpose(1, 2)[..., None])
    p = p.masked_fill(~ok, 0.0)       # exactly 0 on masked entries
    dp = torch.einsum("bqhd,bkhd->bhqk", _unpack(do, nh).float(),
                      _unpack(v, nh).float())
    keep = keep_of(keep, dropout_p, rng, logits.shape, q.device)
    ds = p * (_dropped(dp, keep, dropout_p)
              - delta.float().transpose(1, 2)[..., None])
    return _dropped(p, keep, dropout_p), ds


def _dq_ref(q, k, v, do, lse, delta, nh, causal, scale, seg, seg_k=None,
            **ex):
    scale = _scale_of(q, nh, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg,
                          seg_k, **ex)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _unpack(k, nh).float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def _dkv_ref(q, k, v, do, lse, delta, nh, causal, scale, seg, seg_k=None,
             **ex):
    scale = _scale_of(q, nh, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, nh, causal, scale, seg,
                          seg_k, **ex)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _unpack(q, nh).float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _unpack(do, nh).float())
    return (dk.reshape(k.shape).to(q.dtype),
            dv.reshape(v.shape).to(q.dtype))


def packed_dq_ref(q, k, v, do, lse, delta, nh, causal=True, scale=None,
                  bias=None, dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch K-DQ (mirrors ``_dq_call``): ``dq = scale * ds.k``
    with ``ds = p * (do.v - delta)``, ``p = exp(scale * q.k - lse)``.
    ``lse``, ``delta``: ``(B, Sq, NH)``. ``bias``, ``dropout_p``, ``rng``
    and ``keep`` are the forward's (``packed_attention_ref``). Returns dq
    in q's dtype."""
    return _dq_ref(q, k, v, do, lse, delta, nh, causal, scale, None,
                   bias=bias, dropout_p=dropout_p, rng=rng, keep=keep)


def packed_dkv_ref(q, k, v, do, lse, delta, nh, causal=True, scale=None,
                   bias=None, dropout_p=0.0, rng=None, keep=None):
    """Plain PyTorch K-DKV (mirrors ``_dkv_call``, with lse and delta
    untransposed ``(B, Sq, NH)``): ``dk = scale * ds^T.q``,
    ``dv = p^T.do`` (p the kept probabilities with dropout). Returns
    ``(dk, dv)`` in q's dtype."""
    return _dkv_ref(q, k, v, do, lse, delta, nh, causal, scale, None,
                    bias=bias, dropout_p=dropout_p, rng=rng, keep=keep)


def segment_dq_ref(q, k, v, do, lse, delta, segment_ids, nh, scale=None,
                   segment_ids_k=None, causal=True, dropout_p=0.0, rng=None,
                   keep=None):
    """Plain PyTorch K-SDQ (mirrors ``_dq_call_seg``): ``packed_dq_ref``
    where a pair is visible only where the query's id equals the key's
    (``segment_ids_k``, default the query ids), with p exactly 0 on every
    masked entry."""
    return _dq_ref(q, k, v, do, lse, delta, nh, causal, scale, segment_ids,
                   segment_ids_k, dropout_p=dropout_p, rng=rng, keep=keep)


def segment_dkv_ref(q, k, v, do, lse, delta, segment_ids, nh, scale=None,
                    segment_ids_k=None, causal=True, dropout_p=0.0,
                    rng=None, keep=None):
    """Plain PyTorch K-SDKV (mirrors ``_dkv_call_seg``, with lse and
    delta untransposed ``(B, Sq, NH)``). Returns ``(dk, dv)``."""
    return _dkv_ref(q, k, v, do, lse, delta, nh, causal, scale, segment_ids,
                    segment_ids_k, dropout_p=dropout_p, rng=rng, keep=keep)


def _kernel_device(what, q):
    """A forward wrapper's device rule, checked before its op is called:
    the CPU takes the plain version, CUDA the kernel, and any other
    device (``meta`` included, whose fake would otherwise answer) has no
    kernel."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")


def packed_fwd(q, k, v, nh, causal=True, scale=None):
    """Packed flash forward: the plain version for CPU tensors, K-PACK
    for CUDA tensors. Returns ``(o, lse)``, the outputs of the op
    ``paddle_tpu_torch::packed_fwd``."""
    _kernel_device("packed_fwd", q)
    return torch.ops.paddle_tpu_torch.packed_fwd(
        q, k, v, nh, bool(causal), float(_scale_of(q, nh, scale)))


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


def _key_ids(what, segment_ids, segment_ids_k, causal):
    """The key-side ids (the query ids when none are given); causal
    attention with distinct key ids raises, as the TPU kernel does: its
    triangle compares global positions, where varlen causality is
    aligned per sequence."""
    if segment_ids_k is None:
        return segment_ids
    if causal:
        raise ValueError(
            f"{what}: causal attention with distinct key-side segment ids "
            "is not supported (per-sequence bottom-right alignment); the "
            "CPU takes ops.attention_dispatch.dense_segment_attention")
    return segment_ids_k


def seg_fwd(q, k, v, segment_ids, nh, scale=None, segment_ids_k=None,
            causal=True, dropout_p=0.0, rng=None):
    """Segment-masked forward over ``(B, S, NH*D)`` whose q, k, v may be
    column slices of the fused qkv: the plain version for CPU tensors,
    K-SEG for CUDA tensors (with ``dropout_p``, keyed by ``rng``, its
    DROP variant). Returns ``(o, lse)``, the outputs of the op
    ``paddle_tpu_torch::seg_fwd``."""
    _kernel_device("seg_fwd", q)
    seg_k = _key_ids("seg_fwd", segment_ids, segment_ids_k, causal)
    return torch.ops.paddle_tpu_torch.seg_fwd(
        q, k, v, segment_ids, seg_k, nh, bool(causal),
        float(_scale_of(q, nh, scale)), *_drop_args(dropout_p, rng))


# the JAX package's name for the forward
flash_attention_packed_segmented = seg_fwd


def seg_dq(q, k, v, do, lse, delta, segment_ids, nh, scale=None,
           segment_ids_k=None, causal=True, dropout_p=0.0, rng=None):
    """Segmented dQ: the plain version for CPU tensors, K-SDQ for CUDA
    tensors; ``dropout_p`` and ``rng`` are the forward's."""
    seg_k = _key_ids("seg_dq", segment_ids, segment_ids_k, causal)
    if q.device.type == "cpu":
        return segment_dq_ref(q, k, v, do, lse, delta, segment_ids, nh,
                              scale=scale, segment_ids_k=seg_k,
                              causal=causal, dropout_p=dropout_p, rng=rng)
    dq = _launch_bwd("seg_dq", "dq", q, k, v, do, lse, delta, nh, causal,
                     scale, (segment_ids, seg_k), dropout_p=dropout_p,
                     rng=rng)
    _count(LAUNCHES, "K-SDQ", None, dropout_p)
    return dq


def seg_dkv(q, k, v, do, lse, delta, segment_ids, nh, scale=None,
            segment_ids_k=None, causal=True, dropout_p=0.0, rng=None):
    """Segmented dK, dV: the plain version for CPU tensors, K-SDKV for
    CUDA tensors; ``dropout_p`` and ``rng`` are the forward's. Returns
    ``(dk, dv)``."""
    seg_k = _key_ids("seg_dkv", segment_ids, segment_ids_k, causal)
    if q.device.type == "cpu":
        return segment_dkv_ref(q, k, v, do, lse, delta, segment_ids, nh,
                               scale=scale, segment_ids_k=seg_k,
                               causal=causal, dropout_p=dropout_p, rng=rng)
    dkv = _launch_bwd("seg_dkv", "dkv", q, k, v, do, lse, delta, nh, causal,
                      scale, (segment_ids, seg_k), dropout_p=dropout_p,
                      rng=rng)
    _count(LAUNCHES, "K-SDKV", None, dropout_p)
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


def _check(what, q, k, v, nh, causal, extra=(), seg=None, bias=None,
           dropout_p=0.0, rng=None):
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
        for ids, n, side in ((seg[0], sq, "q"), (seg[1], k.shape[1], "k")):
            if (ids.dtype != torch.int32 or tuple(ids.shape) != (b, n)
                    or not ids.is_contiguous()):
                raise ValueError(f"{what}: {side}-side segment ids must be "
                                 f"contiguous (B, S{side}) = {(b, n)} int32")
        extra = (*extra, *seg)
    if bias is not None:
        if seg is not None:
            raise ValueError(f"{what}: segment ids take no bias")
        extra = (*extra, bias)
    if dropout_p and not (0.0 < dropout_p < 1.0 and rng is not None):
        raise ValueError(f"{what}: dropout_p {dropout_p} must lie in "
                         "(0, 1) and come with rng=(seed, offset)")
    if any(t.device != q.device for t in (k, v, *extra)):
        raise ValueError(f"{what}: tensors on different devices")
    return d


def bias_view(bias, b, nh, sq, sk):
    """An additive mask as the kernels read it: fp32 (a bool mask adds 1
    where true, as the JAX package's ``mask.astype``), broadcast to
    ``(B, NH, Sq, Sk)`` by ``expand`` (a broadcast dimension has stride
    0: nothing is materialised). The kernels give a mask no gradient:
    one off the CPU with ``requires_grad`` raises (on the CPU the plain
    versions' autograd reaches it)."""
    if bias.requires_grad and bias.device.type != "cpu":
        raise ValueError("attention: the kernels give the attention mask "
                         "no gradient; pass it detached")
    if bias.dim() > 4:
        raise ValueError(f"attention: a mask of {bias.dim()} dims does "
                         "not broadcast to (B, H, Sq, Sk)")
    return bias.to(torch.float32).expand(b, nh, sq, sk)


def bias_route(bias):
    """How the bf16 kernels stage a ``bias_view``'s tiles in shared
    memory: ``(strides, tma)``. ``strides`` are its four element strides
    with 0 on every dimension of size 1 as well as on a broadcast one
    (the kernels read coordinate 0 there; a query stride of 0 stages one
    row of keys, read at a row pitch of 0). ``tma`` is whether a TMA box
    can copy the tiles: a key stride of 1, a 16-byte-aligned base and the
    other strides multiples of 16 bytes. Any other layout (a transposed or
    column-broadcast mask, rows not a multiple of 16 bytes) takes the
    producer warp's cp.async route; neither copies the mask on the
    host."""
    strides = tuple(0 if n == 1 else st
                    for n, st in zip(bias.shape, bias.stride()))
    tma = (strides[3] == 1 and bias.data_ptr() % 16 == 0
           and all(st % 4 == 0 for st in strides[:3]))
    return strides, tma


def _ext_args(bias, dropout_p, rng):
    """The DROP and BIAS entries' extra arguments: a ``bias_view``'s
    pointer (null without one), its layout (four element strides and the
    copy route, ``bias_route``), then ``dropout_p``, seed and offset."""
    ptr, strides, tma = None, (0, 0, 0, 0), False
    if bias is not None:
        ptr = bias.data_ptr()
        strides, tma = bias_route(bias)
        if max(strides) >= 2 ** 31:
            raise ValueError(f"mask stride {max(strides)} exceeds int32")
    seed, offset = (int(x) % 2 ** 64 for x in (rng or (0, 0)))
    return ptr, (*strides, int(tma)), float(dropout_p), seed, offset


def _drop_args(dropout_p, rng):
    """``(dropout_p, seed, offset)`` of a call (seed and offset as int64
    for the ops' schemas; 0 without dropout)."""
    if not dropout_p:
        return 0.0, 0, 0
    if rng is None:
        raise ValueError("attention dropout needs rng=(seed, offset)")
    seed, offset = (int(x) % 2 ** 64 for x in rng)
    return (float(dropout_p), seed - 2 ** 64 * (seed >= 2 ** 63),
            offset - 2 ** 64 * (offset >= 2 ** 63))


def _launch_fwd(what, q, k, v, nh, causal, scale, seg=None, bias=None,
                dropout_p=0.0, rng=None):
    """One forward launch (K-PACK, or K-SEG with ``seg`` = the query- and
    key-side ids; with a ``bias_view`` or ``dropout_p`` the entry of the
    BIAS and DROP variants); the caller counts it. Returns ``(o, lse)``."""
    d = _check(what, q, k, v, nh, causal, seg=seg, bias=bias,
               dropout_p=dropout_p, rng=rng)
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
        if bias is not None or dropout_p:
            entry = "flash_attention_fwd_ext"
            ids = (None, None) if seg is None else tuple(
                t.data_ptr() for t in seg)
            ptr, layout, p, seed, offset = _ext_args(bias, dropout_p, rng)
            rc = lib.flash_attention_fwd_ext(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *ids, ptr,
                o.data_ptr(), lse.data_ptr(), b, sq, sk, nh, d, q_rs, k_rs,
                v_rs, *layout, float(scale), int(bool(causal)), p, seed,
                offset, code, stream)
        elif seg is None:
            entry = "flash_attention_fwd_packed"
            rc = lib.flash_attention_fwd_packed(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, sq, sk, nh, d, q_rs, k_rs, v_rs,
                float(scale), int(bool(causal)), code, stream)
        else:
            entry = "flash_attention_fwd_packed_seg"
            rc = lib.flash_attention_fwd_packed_seg(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg[0].data_ptr(),
                seg[1].data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, sk,
                nh, d, q_rs, k_rs, v_rs, float(scale), int(bool(causal)),
                code, stream)
    _build.check(rc, entry)
    return o, lse


def _launch_bwd(what, kind, q, k, v, do, lse, delta, nh, causal, scale,
                seg=None, bias=None, dropout_p=0.0, rng=None):
    """One backward launch; the caller counts it. ``kind`` ``"dq"``
    launches a dQ kernel and returns dq, ``"dkv"`` a dK/dV kernel and
    returns ``(dk, dv)``; ``seg`` (the query- and key-side ids) selects
    the segmented entries, a ``bias_view`` or ``dropout_p`` (with the
    forward's ``rng``) the entries of the BIAS and DROP variants."""
    d = _check(what, q, k, v, nh, causal, extra=(do, lse, delta), seg=seg,
               bias=bias, dropout_p=dropout_p, rng=rng)
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
    dims = (b, sq, sk, nh, d, q_rs, k_rs, v_rs, do_rs, float(scale),
            int(bool(causal)))
    if bias is not None or dropout_p:
        entry += "_ext"
        ptr, layout, p, seed, offset = _ext_args(bias, dropout_p, rng)
        ptrs += ([None, None] if seg is None
                 else [ids.data_ptr() for ids in seg]) + [ptr]
        dims = (*dims[:9], *layout, *dims[9:], p, seed, offset)
    elif seg is not None:
        entry += "_seg"
        ptrs += [ids.data_ptr() for ids in seg]
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


# -- the two training forwards as ops a remat policy can name ---------------
#
# ``torch.utils.checkpoint``'s selective policies see dispatcher-level
# ops, not Python functions: registered as operators of the
# ``paddle_tpu_torch`` library, the forwards are visible to them. Their
# two outputs are the values the JAX package tags ``attn_out_kernel`` (o)
# and ``attn_lse`` (lse): a policy that saves the op keeps both, and the
# recompute then never runs the kernel again. The CUDA implementation
# launches the kernel and counts it in ``LAUNCHES``, the CPU one runs the
# plain version and counts it in ``PLAIN_CALLS``, the Meta one gives the
# shapes. ``FlashAttentionPacked`` and ``FlashAttentionPackedSeg`` call
# the ops in their forwards and carry the autograd formula (the JAX
# package's custom_vjp): ``delta`` per head in fp32, then the dQ and
# dK/dV kernels. The operators are defined through ``torch.library``'s
# ``Library`` rather than ``torch.library.custom_op``, whose per-call
# checks cost several times the host time of the rest of the launch.

# the names the JAX package gives the forward op's outputs
OUTPUT_NAMES = ("attn_out_kernel", "attn_lse")

# plain-version forward calls since the last reset (CPU tensors), so the
# CPU tests count what a remat policy replays as the card counts launches
PLAIN_CALLS = {"K-PACK": 0, "K-SEG": 0}

_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_LIB.define("packed_fwd(Tensor q, Tensor k, Tensor v, int nh, bool causal, "
            "float scale) -> (Tensor, Tensor)")
_LIB.define("seg_fwd(Tensor q, Tensor k, Tensor v, Tensor segment_ids, "
            "Tensor segment_ids_k, int nh, bool causal, float scale, "
            "float dropout_p=0.0, int seed=0, int offset=0) -> "
            "(Tensor, Tensor)")


def _packed_fwd_cpu(q, k, v, nh, causal, scale):
    PLAIN_CALLS["K-PACK"] += 1
    return packed_attention_ref(q, k, v, nh, causal=causal, scale=scale)


def _packed_fwd_cuda(q, k, v, nh, causal, scale):
    out = _launch_fwd("packed_fwd", q, k, v, nh, causal, scale)
    LAUNCHES["K-PACK"] += 1
    return out


def _rng_of(dropout_p, seed, offset):
    return (seed % 2 ** 64, offset % 2 ** 64) if dropout_p else None


def _seg_fwd_cpu(q, k, v, segment_ids, segment_ids_k, nh, causal, scale,
                 dropout_p=0.0, seed=0, offset=0):
    PLAIN_CALLS["K-SEG"] += 1
    return segment_attention_ref(q, k, v, segment_ids, nh, scale=scale,
                                 segment_ids_k=segment_ids_k, causal=causal,
                                 dropout_p=dropout_p,
                                 rng=_rng_of(dropout_p, seed, offset))


def _seg_fwd_cuda(q, k, v, segment_ids, segment_ids_k, nh, causal, scale,
                  dropout_p=0.0, seed=0, offset=0):
    out = _launch_fwd("seg_fwd", q, k, v, nh, causal, scale,
                      (segment_ids, segment_ids_k), dropout_p=dropout_p,
                      rng=_rng_of(dropout_p, seed, offset))
    _count(LAUNCHES, "K-SEG", None, dropout_p)
    return out


def _fwd_meta(q, nh):
    b, sq, hp = q.shape
    return (q.new_empty((b, sq, hp)),
            q.new_empty((b, sq, nh), dtype=torch.float32))


for _name, _cpu, _cuda, _meta in (
        ("packed_fwd", _packed_fwd_cpu, _packed_fwd_cuda,
         lambda q, k, v, nh, causal, scale: _fwd_meta(q, nh)),
        ("seg_fwd", _seg_fwd_cpu, _seg_fwd_cuda,
         lambda q, k, v, segment_ids, segment_ids_k, nh, causal, scale,
         dropout_p=0.0, seed=0, offset=0: _fwd_meta(q, nh))):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _meta, "Meta")

# the ops a remat policy saves to keep both named outputs
FORWARD_OPS = (torch.ops.paddle_tpu_torch.packed_fwd.default,
               torch.ops.paddle_tpu_torch.seg_fwd.default)


class FlashAttentionPacked(torch.autograd.Function):
    """Packed flash attention with its backward (mirrors the JAX
    package's ``_flash_packed`` custom_vjp): the forward is the op
    ``paddle_tpu_torch::packed_fwd`` (K-PACK) and saves
    ``(q, k, v, o, lse)``; the backward computes ``delta`` per head in
    fp32 and runs K-DQ and K-DKV. On CPU tensors each step is its plain
    version."""

    @staticmethod
    def forward(ctx, q, k, v, nh, causal, scale):
        o, lse = torch.ops.paddle_tpu_torch.packed_fwd(q, k, v, nh, causal,
                                                       scale)
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
    _kernel_device("flash_attention_packed", q)
    scale = float(_scale_of(q, nh, scale))
    return FlashAttentionPacked.apply(q, k, v, nh, bool(causal), scale)


class FlashAttentionPackedSeg(torch.autograd.Function):
    """Segment-masked flash attention with its backward (mirrors the JAX
    package's ``_flash_packed_seg`` custom_vjp): the forward is the op
    ``paddle_tpu_torch::seg_fwd`` (K-SEG) and saves
    ``(q, k, v, seg_q, seg_k, o, lse)`` and the dropout key; the backward
    computes ``delta`` per head in fp32 (over the dropped output) and
    runs K-SDQ and K-SDKV, which regenerate the forward's keep bits. The
    ids take no gradient. On CPU tensors each step is its plain
    version."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, nh, causal, scale, dropout_p,
                rng):
        o, lse = torch.ops.paddle_tpu_torch.seg_fwd(
            q, k, v, seg_q, seg_k, nh, causal, scale,
            *_drop_args(dropout_p, rng))
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.attn = (nh, causal, scale, dropout_p, rng)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        nh, causal, scale, dropout_p, rng = ctx.attn
        delta = _delta(do, o, nh)
        # the ids the forward checked: seg_k is seg_q's own tensor when the
        # caller gave no key-side ids, so causal passes it as None
        kw = dict(scale=scale, causal=causal,
                  segment_ids_k=None if causal else seg_k,
                  dropout_p=dropout_p, rng=rng)
        dq = seg_dq(q, k, v, do, lse, delta, seg_q, nh, **kw)
        dk, dv = seg_dkv(q, k, v, do, lse, delta, seg_q, nh, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_packed_seg(q, k, v, segment_ids, nh, scale=None,
                               segment_ids_k=None, causal=True,
                               dropout_p=0.0, rng=None):
    """Differentiable segment-masked attention over ``(B, S, NH*D)`` (the
    JAX package's ``flash_attention_packed_segmented``): returns ``o``.
    q, k, v may be column slices of the fused qkv; ``segment_ids``
    ``(B, Sq)`` and ``segment_ids_k`` ``(B, Sk)`` (default: the query
    ids; only with ``causal=False``) are taken as int32. ``dropout_p``
    drops the probabilities with the Philox bits of ``rng`` (default: a
    key from ``framework.random.next_rng_key``)."""
    if q.shape[-1] % nh:
        raise ValueError(f"hidden {q.shape[-1]} not divisible by num_heads "
                         f"{nh}")
    if tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != "
                         f"batch/seq {tuple(q.shape[:2])}")
    if (segment_ids_k is not None
            and tuple(segment_ids_k.shape) != tuple(k.shape[:2])):
        raise ValueError(f"segment_ids_k shape "
                         f"{tuple(segment_ids_k.shape)} != batch/seq "
                         f"{tuple(k.shape[:2])}")
    _kernel_device("flash_attention_packed_seg", q)
    seg_q = segment_ids.to(torch.int32).contiguous()
    seg_k = _key_ids("flash_attention_packed_seg", seg_q,
                     None if segment_ids_k is None
                     else segment_ids_k.to(torch.int32).contiguous(), causal)
    scale = float(_scale_of(q, nh, scale))
    dropout_p = float(dropout_p)
    if dropout_p and rng is None:
        from ...framework.random import next_rng_key

        rng = next_rng_key()
    return FlashAttentionPackedSeg.apply(q, k, v, seg_q, seg_k, nh,
                                         bool(causal), scale, dropout_p,
                                         rng if dropout_p else None)
