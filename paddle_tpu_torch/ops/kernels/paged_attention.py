"""K-DEC: paged decode attention, the serving decode step's kernel.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
``_decode_kernel`` (launched by ``_paged_call``; fp32 and bf16 pools, the
int8 variant is not ported yet). The CUDA source is
``paddle_tpu_torch/csrc/paged_attention.cu``.

Layouts (the serving engine's contract, as in the JAX package):
``q`` ``(B, nh, d)``; ``k_pages``/``v_pages`` ``(P, page_size, nh_kv*d)``;
``page_table`` ``(B, max_pages)`` int32; ``seq_lens`` ``(B,)`` int32,
0 marking a padding row whose output is zeros.

What bounds it on the H100: the K/V bytes of the tokens each request
really holds (``sum_b seq_len_b * 2 * nh_kv * d * elem``); the arithmetic
is a few hundred FLOPs per KV row. The kernel reads exactly those rows:
one CTA per (request, head) loops only over the request's own tokens,
four in flight per warp, each K/V row one coalesced warp load, with an
fp32 online softmax merged across warps at the end. The TPU kernel had
to fetch and mask every page of the table.

``paged_decode_attention`` takes the plain version for CPU tensors only;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_attention_ref"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = {"K-DEC": 0}
_NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        scale=None):
    """Plain PyTorch version (mirrors ``paged_attention_xla``): gather
    each request's pages dense and run one masked fp32 softmax; a
    ``seq_len`` 0 row outputs zeros."""
    b, nh, d = q.shape
    _, page_size, hp_kv = k_pages.shape
    nh_kv = hp_kv // d
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    max_pages = page_table.shape[1]
    pt = page_table.long()
    k = k_pages[pt].reshape(b, max_pages * page_size, nh_kv, d)
    v = v_pages[pt].reshape(b, max_pages * page_size, nh_kv, d)
    if nh_kv != nh:  # GQA: expand kv heads to query heads
        k = k.repeat_interleave(nh // nh_kv, dim=2)
        v = v.repeat_interleave(nh // nh_kv, dim=2)
    qf = (q * scale).float()
    logits = torch.einsum("bhd,bkhd->bhk", qf, k.float())
    pos = torch.arange(max_pages * page_size, device=q.device)
    ok = (pos[None, :] < seq_lens.long()[:, None])[:, None, :]
    p = torch.softmax(logits.masked_fill(~ok, _NEG_INF), dim=-1)
    p = p.masked_fill(~ok, 0.0)  # rows with seq_len 0 -> zeros
    return torch.einsum("bhk,bkhd->bhd", p.to(v.dtype), v)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None):
    """One decode step of paged attention: the plain version for CPU
    tensors, the K-DEC kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table,
                                   seq_lens, scale=scale)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, scale)


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale):
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    if q.dim() != 3 or k_pages.dim() != 3:
        raise ValueError("paged_decode_attention: q (B, nh, d) and pools "
                         "(P, page_size, nh_kv*d) expected")
    b, nh, d = q.shape
    _, page_size, hp_kv = k_pages.shape
    if d not in (64, 128):
        raise ValueError(f"paged_decode_attention: head_dim {d} not in "
                         "(64, 128), the kernel's instantiations")
    if v_pages.shape != k_pages.shape or hp_kv % d:
        raise ValueError(f"paged_decode_attention: pools {k_pages.shape}/"
                         f"{v_pages.shape} do not hold whole heads of {d}")
    nh_kv = hp_kv // d
    if nh % nh_kv:
        raise ValueError(f"paged_decode_attention: {nh} query heads not "
                         f"divisible by {nh_kv} kv heads")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"paged_decode_attention: q {q.dtype} and pools "
                        f"{k_pages.dtype}/{v_pages.dtype} differ")
    if (page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != b
            or tuple(seq_lens.shape) != (b,)):
        raise ValueError("paged_decode_attention: page_table (B, max_pages)"
                         " and seq_lens (B,) int32 expected")
    ts = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_decode_attention: tensors on different "
                         "devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention: tensors must be "
                         "contiguous")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, nh, nh_kv, d, page_size, page_table.shape[1], float(scale),
            _build.dtype_code(q.dtype), stream)
    _build.check(rc, "paged_attention_decode")
    LAUNCHES["K-DEC"] += 1
    return out
