"""Paged attention, the serving decode and verify steps' kernels.

==========  ==========================================================
kernel      replaces (``paddle_tpu/ops/pallas/paged_attention.py``)
==========  ==========================================================
K-DEC       ``_decode_kernel`` (``_paged_call``), fp32 and bf16 pools
K-DEC8      ``_decode_kernel`` with ``quantized=True``: int8 pools and
            their ``(P, 2, nh_kv)`` fp32 scales
K-MQ        ``_mq_kernel`` (``paged_multiquery_attention``): the
            speculative-decoding verify window, fp32 and bf16 pools
K-MQ8       ``_mq_kernel`` with ``quantized=True``
==========  ==========================================================

The CUDA source is ``paddle_tpu_torch/csrc/paged_attention.cu``: one
split kernel (``paged_split_kernel``) and one merge kernel
(``paged_merge_kernel``) serve all four, over pools in the query's dtype
or in int8, for one query row (decode) and windows of up to
:data:`MAX_QLEN` rows (verify).

Layouts (the serving engine's contract, as in the JAX package):
``q`` ``(B, nh, d)`` (decode) or ``(B, qlen, nh, d)`` (verify);
``k_pages``/``v_pages`` ``(P, page_size, nh_kv*d)``; ``page_table``
``(B, max_pages)`` int32; ``seq_lens`` ``(B,)`` int32 tokens of context
including the new token(s), 0 marking a padding row whose output is
zeros; ``scales`` ``(P, 2, nh_kv)`` fp32 for int8 pools (``[:, 0]`` K,
``[:, 1]`` V, symmetric absmax per page and kv head). Window row ``i``
sees key positions ``< seq_len - qlen + i + 1``. The output has q's
shape and dtype.

What bounds them on the H100: the K/V bytes of the tokens each request
really holds (``sum_b seq_len_b * 2 * nh_kv * d * elem``, elem 1 for
int8); the arithmetic is ``4 * qlen * (nh / nh_kv) * d`` FLOPs per K/V
row. The kernels split each request's context into chunks of
:func:`split_plan`'s whole pages (about 256 tokens), one CTA per
(chunk, request, kv head) serving every query row that reads the head,
and stream the chunk's pages through a ring of ``cp.async`` copies in
shared memory; a second kernel merges the chunks' ``(m, l, acc)`` in base
2. A bf16 query with at least :data:`TENSOR_CORE_ROWS` rows a kv head (the
verify window, GQA) takes the tensor-core body (``mma.sync``), the rest
the CUDA-core body. The grid, the body and the fp32 workspace come from
shapes and dtypes alone (:func:`launch_plan`): the host never reads
``seq_lens``.
:func:`paged_split_ref` states the split and the merge in plain PyTorch
(the CPU tests hold it to the JAX package); nothing on the main path
calls it. The int8 dequant is fused into the dot products with the
page's scales, as on the TPU; no fp32 copy of the cache is made.

The wrappers take the plain version for CPU tensors only; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_multiquery_attention",
           "paged_attention_ref", "paged_multiquery_attention_ref",
           "paged_split_ref", "split_plan", "launch_plan", "MAX_QLEN"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = {"K-DEC": 0, "K-DEC8": 0, "K-MQ": 0, "K-MQ8": 0}
MAX_QLEN = 8        # the widest window K-MQ takes (kMaxQlen in the source)
CHUNK_TOKENS = 256  # a chunk's tokens, rounded down to whole pages
TENSOR_CORE_ROWS = 4     # rows a kv head from which bf16 takes mma.sync
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def split_plan(page_size, max_pages):
    """``(chunk_pages, n_chunks)``: each request's context is cut into
    chunks of ``chunk_pages`` whole pages (about :data:`CHUNK_TOKENS`
    tokens, at least one page), ``n_chunks`` of them over the table."""
    chunk_pages = max(1, CHUNK_TOKENS // page_size)
    return chunk_pages, -(-max_pages // chunk_pages)


def launch_plan(b, qlen, nh, nh_kv, d, page_size, max_pages,
                tensor_cores=False):
    """The kernels' launch from shapes alone: the split kernel's grid
    ``(n_chunks * row_tiles, B, nh_kv)``, the query rows each CTA serves
    (``rows_per_cta``) and the fp32 workspace of the chunks' ``(acc, m,
    l)``, ``None`` with one chunk (the split kernel then writes the
    output itself). A kv head is read by ``qlen * nh / nh_kv`` rows; with
    ``tensor_cores`` (a bf16 query, over bf16 or int8 pools) and at least
    :data:`TENSOR_CORE_ROWS` of them a CTA takes them in tiles of 16 on
    the tensor cores, else on the CUDA cores in tiles of 1, 2, 4 or 8 (at
    most 4 at d 128)."""
    chunk_pages, n_chunks = split_plan(page_size, max_pages)
    rows = qlen * (nh // nh_kv)
    if tensor_cores and rows >= TENSOR_CORE_ROWS:
        rows_per_cta = 16
    else:
        rows_per_cta = min(8 if d == 64 else 4,
                           1 << (rows - 1).bit_length())
    row_tiles = -(-rows // rows_per_cta)
    return {"chunk_pages": chunk_pages, "n_chunks": n_chunks,
            "rows_per_cta": rows_per_cta, "row_tiles": row_tiles,
            "grid": (n_chunks * row_tiles, b, nh_kv),
            "workspace": ((n_chunks, b, qlen, nh, d + 2) if n_chunks > 1
                          else None)}


def _gather_dequant(fn, k_pages, v_pages, page_table, scales, d):
    """Each request's pages dense ``(B, max_pages*page_size, nh_kv*d)``,
    dequantized with the per-(page, kv head) scales when the pools are
    int8 (mirrors the JAX package's ``_gather_dequant``)."""
    b, max_pages = page_table.shape
    _, page_size, hp_kv = k_pages.shape
    pt = page_table.long()
    k, v = k_pages[pt], v_pages[pt]          # (B, max_pages, ps, hp_kv)
    if scales is not None:
        nh_kv = hp_kv // d
        _check_scales(fn, scales, k_pages, nh_kv)
        s = scales[pt]                       # (B, max_pages, 2, nh_kv)

        def deq(x, sc):
            x = x.view(b, max_pages, page_size, nh_kv, -1).float()
            return x * sc[:, :, None, :, None]

        k, v = deq(k, s[:, :, 0]), deq(v, s[:, :, 1])
    rows = max_pages * page_size
    return k.reshape(b, rows, hp_kv), v.reshape(b, rows, hp_kv)


def paged_multiquery_attention_ref(q, k_pages, v_pages, page_table,
                                   seq_lens, scale=None, scales=None):
    """Plain PyTorch version (mirrors ``paged_multiquery_attention_xla``):
    gather each request's pages dense, dequantize int8 pools with their
    scales, and run one window-causal masked fp32 softmax; a ``seq_len``
    0 row outputs zeros. qlen 1 delegates to :func:`paged_attention_ref`,
    so an empty draft is bit-identical to the decode step."""
    b, qlen, nh, d = q.shape
    if qlen == 1:
        return paged_attention_ref(q[:, 0], k_pages, v_pages, page_table,
                                   seq_lens, scale=scale,
                                   scales=scales)[:, None]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k, v = _gather_dequant("paged_multiquery_attention_ref", k_pages,
                           v_pages, page_table, scales, d)
    rows = k.shape[1]
    k = k.view(b, rows, -1, d)
    v = v.view(b, rows, -1, d)
    if k.shape[2] != nh:  # GQA: expand kv heads to query heads
        k = k.repeat_interleave(nh // k.shape[2], dim=2)
        v = v.repeat_interleave(nh // v.shape[2], dim=2)
    qf = (q * scale).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    pos = torch.arange(rows, device=q.device)
    bound = (seq_lens.long()[:, None] - qlen
             + torch.arange(qlen, device=q.device)[None, :] + 1)
    ok = (pos[None, None, :] < bound[:, :, None])[:, None]  # (B,1,qlen,S)
    p = torch.softmax(logits.masked_fill(~ok, _NEG_INF), dim=-1)
    p = p.masked_fill(~ok, 0.0)  # all-masked rows -> zeros
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        scale=None, scales=None):
    """Plain PyTorch version (mirrors ``paged_attention_xla``): gather
    each request's pages dense, dequantize int8 pools with their scales,
    and run one masked fp32 softmax; a ``seq_len`` 0 row outputs
    zeros."""
    b, nh, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k, v = _gather_dequant("paged_attention_ref", k_pages, v_pages,
                           page_table, scales, d)
    rows = k.shape[1]
    k = k.view(b, rows, -1, d)
    v = v.view(b, rows, -1, d)
    if k.shape[2] != nh:  # GQA: expand kv heads to query heads
        k = k.repeat_interleave(nh // k.shape[2], dim=2)
        v = v.repeat_interleave(nh // v.shape[2], dim=2)
    qf = (q * scale).float()
    logits = torch.einsum("bhd,bkhd->bhk", qf, k.float())
    pos = torch.arange(rows, device=q.device)
    ok = (pos[None, :] < seq_lens.long()[:, None])[:, None, :]
    p = torch.softmax(logits.masked_fill(~ok, _NEG_INF), dim=-1)
    p = p.masked_fill(~ok, 0.0)  # rows with seq_len 0 -> zeros
    return torch.einsum("bhk,bkhd->bhd", p.to(v.dtype), v).to(q.dtype)


def paged_split_ref(q, k_pages, v_pages, page_table, seq_lens,
                    scale=None, scales=None):
    """The kernels' split and merge in plain PyTorch, ``q``
    ``(B, qlen, nh, d)``: per chunk of :func:`split_plan`'s pages, each
    row's partial ``(m, l, acc)`` in base 2 over the positions it sees;
    then the chunks a request's length reaches, merged. Computes what
    :func:`paged_multiquery_attention_ref` does (qlen 1 is the decode);
    nothing on the main path calls it."""
    b, qlen, nh, d = q.shape
    max_pages = page_table.shape[1]
    page_size = k_pages.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k, v = _gather_dequant("paged_split_ref", k_pages, v_pages, page_table,
                           scales, d)
    rows = k.shape[1]
    k = k.view(b, rows, -1, d).float()
    v = v.view(b, rows, -1, d).float()
    if k.shape[2] != nh:  # GQA: query head h reads kv head h // group
        k = k.repeat_interleave(nh // k.shape[2], dim=2)
        v = v.repeat_interleave(nh // v.shape[2], dim=2)
    qs = q.float() * (scale * _LOG2E)
    seq = seq_lens.long()
    length = seq.clamp(max=rows)          # past the table: clamped
    lim = torch.minimum(length[:, None], seq[:, None] - qlen + 1
                        + torch.arange(qlen, device=q.device)[None, :])
    chunk_pages, n_chunks = split_plan(page_size, max_pages)
    chunk = chunk_pages * page_size
    ms, ls, accs, live = [], [], [], []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, rows)
        s = torch.einsum("bqhd,bkhd->bqhk", qs, k[:, lo:hi])
        pos = torch.arange(lo, hi, device=q.device)
        ok = (pos[None, None, :] < lim[:, :, None])[:, :, None, :]
        s = s.masked_fill(~ok, _NEG_INF)
        m = s.amax(-1)                                 # (B, qlen, nh)
        p = torch.exp2(s - m[..., None]).masked_fill(~ok, 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqhk,bkhd->bqhd", p, v[:, lo:hi]))
        live.append(lo < length)                       # (B,)
    live = torch.stack(live)[:, :, None, None]         # (C, B, 1, 1)
    m = torch.stack(ms).masked_fill(~live, _NEG_INF)   # dead chunks: none
    mm = m.amax(0)
    w = torch.exp2(m - mm).masked_fill(~live, 0.0)
    l = (torch.stack(ls) * w).sum(0)
    o = (torch.stack(accs) * w[..., None]).sum(0)
    o = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None],
                    torch.zeros_like(o))
    return o.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None, scales=None):
    """One decode step of paged attention, ``q`` ``(B, nh, d)``: the
    plain version for CPU tensors, K-DEC (K-DEC8 with int8 pools and
    ``scales``) for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table,
                                   seq_lens, scale=scale, scales=scales)
    if q.dim() != 3:
        raise ValueError("paged_decode_attention: q (B, nh, d) expected")
    out = _launch("paged_attention_decode", q[:, None], k_pages, v_pages,
                  page_table, seq_lens, scale, scales)
    LAUNCHES["K-DEC8" if scales is not None else "K-DEC"] += 1
    return out[:, 0]


def paged_multiquery_attention(q, k_pages, v_pages, page_table, seq_lens,
                               scale=None, scales=None):
    """The speculative verify window, ``q`` ``(B, qlen, nh, d)`` with
    ``1 <= qlen <= MAX_QLEN``, causal within the window: the plain
    version for CPU tensors, K-MQ (K-MQ8 with int8 pools and ``scales``)
    for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_multiquery_attention_ref(
            q, k_pages, v_pages, page_table, seq_lens, scale=scale,
            scales=scales)
    if q.dim() != 4 or not 1 <= q.shape[1] <= MAX_QLEN:
        raise ValueError(f"paged_multiquery_attention: q (B, qlen, nh, d) "
                         f"with 1 <= qlen <= {MAX_QLEN} expected, got "
                         f"{tuple(q.shape)}")
    out = _launch("paged_attention_multiquery", q, k_pages, v_pages,
                  page_table, seq_lens, scale, scales)
    LAUNCHES["K-MQ8" if scales is not None else "K-MQ"] += 1
    return out


def _check_scales(fn, scales, k_pages, nh_kv):
    """As the JAX package's ``_check_scales``: int8 pools and a
    ``(P, 2, nh_kv)`` fp32 scale pool."""
    if k_pages.dtype != torch.int8:
        raise ValueError(f"{fn}: scales given but pools are "
                         f"{k_pages.dtype}, not int8")
    if tuple(scales.shape) != (k_pages.shape[0], 2, nh_kv):
        raise ValueError(f"{fn}: scales shape {tuple(scales.shape)} != "
                         f"{(k_pages.shape[0], 2, nh_kv)} (per-page K/V "
                         "scales per kv head)")
    if scales.dtype != torch.float32:
        raise TypeError(f"{fn}: scales must be float32, got {scales.dtype}")


def _kernel_args(entry, q, k_pages, v_pages, page_table, seq_lens, scale,
                 scales):
    """Check ``q`` ``(B, qlen, nh, d)`` and the pools, allocate the output
    and the workspace, and return ``(output, the C entry's arguments
    before the stream, workspace)``. Reads shapes, dtypes and pointers
    only: no value of ``seq_lens`` or ``page_table`` reaches the host."""
    fn = ("paged_decode_attention" if entry == "paged_attention_decode"
          else "paged_multiquery_attention")
    if k_pages.dim() != 3:
        raise ValueError(f"{fn}: pools (P, page_size, nh_kv*d) expected")
    b, qlen, nh, d = q.shape
    _, page_size, hp_kv = k_pages.shape
    if d not in (64, 128):
        raise ValueError(f"{fn}: head_dim {d} not in (64, 128), the "
                         "kernel's instantiations")
    if v_pages.shape != k_pages.shape or hp_kv % d:
        raise ValueError(f"{fn}: pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not hold whole heads "
                         f"of {d}")
    nh_kv = hp_kv // d
    if nh % nh_kv:
        raise ValueError(f"{fn}: {nh} query heads not divisible by "
                         f"{nh_kv} kv heads")
    if scales is not None:
        _check_scales(fn, scales, k_pages, nh_kv)
        if v_pages.dtype != torch.int8:
            raise TypeError(f"{fn}: k pools int8, v pools {v_pages.dtype}")
    elif not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{fn}: q {q.dtype} and pools {k_pages.dtype}/"
                        f"{v_pages.dtype} differ")
    if (page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != b
            or tuple(seq_lens.shape) != (b,)):
        raise ValueError(f"{fn}: page_table (B, max_pages) and seq_lens "
                         "(B,) int32 expected")
    ts = [q, k_pages, v_pages, page_table, seq_lens]
    if scales is not None:
        ts.append(scales)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{fn}: tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{fn}: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{fn}: pools must start on a 16-byte boundary "
                         "(the kernel copies 16-byte pieces)")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    max_pages = page_table.shape[1]
    plan = launch_plan(b, qlen, nh, nh_kv, d, page_size, max_pages,
                       tensor_cores=q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    ws = (None if plan["workspace"] is None else
          torch.empty(plan["workspace"], dtype=torch.float32,
                      device=q.device))
    mq = () if entry == "paged_attention_decode" else (qlen,)
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if scales is None else scales.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, *mq, nh, nh_kv, d, page_size, max_pages,
            plan["chunk_pages"], plan["rows_per_cta"], float(scale),
            _build.dtype_code(q.dtype))
    return out, args, ws


def _launch(entry, q, k_pages, v_pages, page_table, seq_lens, scale,
            scales):
    """Launch ``entry`` (the split kernel, then the merge kernel when
    there is more than one chunk) on the current stream. Returns the
    output, q's shape."""
    if q.device.type != "cuda":
        fn = ("paged_decode_attention" if entry == "paged_attention_decode"
              else "paged_multiquery_attention")
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    out, args, _ws = _kernel_args(entry, q, k_pages, v_pages, page_table,
                                 seq_lens, scale, scales)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(rc, entry)
    return out
