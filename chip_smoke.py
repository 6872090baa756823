#!/usr/bin/env python3
"""Drive the paddle_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 0,1,2  # device, build, kernel checks
    python3 chip_smoke.py --phases 0,1,10,11,12   # the new training paths

Phases (any failure raises and exits non-zero; nothing is skipped):

0. device: require CUDA, print the card's name and power limit;
1. build: compile ``paddle_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the widths of the paths that launch it, timed with
   CUDA events (median of >= 20 runs after warm-up) beside its plain
   version, the one PyTorch library call that computes the same function
   (where one exists) and its bound (bytes over HBM bandwidth or FLOPs
   over peak, whichever is larger, at the published peak of the part);
3. serving accuracy, fp32: GPT-345M (random weights from seed 0)
   answers 3 requests through the continuous-batching scheduler, and
   ``generate()`` completes 2 prompts; the card's logits at every
   generated position are held against a teacher-forced full forward of
   the same weights on the CPU;
4. serving load, bf16: 64 requests through the scheduler at
   ``ServingConfig(page_size=16, max_model_len=1024, max_batch=32,
   max_prefill_tokens=2048)``; every request finishes, no page leaks,
   kernel launches equal steps x layers; prints throughput and latency;
5. ``generate()``, bf16: batch 4, 256-token prompts, 64 new tokens;
6. (opt-in) profile of 20 decode ticks;
7. training accuracy, fp32: GPT-345M (params from the port's
   ``gpt_init``, generator seed 0) on a 2 x 256 batch; the grads of
   ``gpt_loss`` on the card against the same grads on the CPU, every
   leaf within 1e-4 of its largest CPU grad, then 3 trainer steps on
   each side: losses within 1e-4, grad norms within 1e-4 relative;
8. training, bf16: ``HybridParallelTrainer`` on a fixed 8 x 1024 batch,
   remat and the guard on: 1 warm-up step, then 10 timed
   ``step_presharded`` calls with one synchronisation at the end; step
   ms, tokens/s, MFU, peak memory; losses finite and falling, and per
   step 48 K-PACK (forward + remat recompute), 24 K-DQ and 24 K-DKV;
9. (opt-in) profile of 3 training steps at phase 8's shape;
10. packed training accuracy, fp32: phase 7 with
    ``TrainerConfig(packed_sequences=True)`` on 2 x 256 rows packed by
    ``io.packing.pack_documents`` (each >= 3 documents and a pad tail),
    ``gpt_loss`` with segment ids and positions;
11. packed training, bf16: phase 8 with ``packed_sequences=True`` on 8 x
    1024 rows packed from documents of 32..1024 tokens (numpy seed 0);
    step ms, tokens/s, real (non-pad) tokens/s, packing efficiency, MFU,
    peak memory; losses finite, and per step 48 K-SEG, 24 K-SDQ, 24
    K-SDKV and no K-PACK, K-DQ or K-DKV;
12. nn-API training: ``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` ->
    ``loss.backward()``; fp32 at 2 x 256, every parameter's grad on the
    card within 1e-4 of its largest CPU grad (``qkv_proj`` included: its
    grad flows only through K-BSHD's backward); then bf16
    ``torch.optim.AdamW`` steps at 4 x 1024: losses finite, and per step
    24 K-BSHD, 24 K-BDQ and 24 K-BDKV;
13. (opt-in) profile of 3 packed training steps at phase 11's shape.

Each main-path phase (3-5, 7, 8, 10-12) sets the kernels' launch counts
to 0 just before it and reads them just after. The line before the last
is the kernels' JSON summary; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.io.packing import pack_documents, packing_efficiency
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_345m)
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.parallel import hybrid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                      ServingConfig, ServingEngine)
from paddle_tpu_torch.utils.tree import flatten

# published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores, HBM bytes/s
PEAKS = {
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "hbm": 2.0e12},
    "H100": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},   # SXM
}
DEV = torch.device("cuda")   # the card


def model_config():
    """GPT-345M at its published widths and depth, dropout off."""
    return gpt_345m(hidden_dropout=0.0, attention_dropout=0.0)


LAYERS = model_config().num_layers
SOURCES = {
    "K-DEC": ("paddle_tpu_torch/csrc/paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:70"),
    "K-SEG": ("paddle_tpu_torch/csrc/flash_attention_fwd.cu",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:467"),
    "K-BSHD": ("paddle_tpu_torch/csrc/flash_attention_fwd.cu",
               "paddle_tpu/ops/pallas/flash_attention.py:63"),
    "K-PACK": ("paddle_tpu_torch/csrc/flash_attention_fwd.cu",
               "paddle_tpu/ops/pallas/flash_attention_packed.py:49"),
    "K-DQ": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention_packed.py:106"),
    "K-DKV": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:159"),
    "K-SDQ": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:523"),
    "K-SDKV": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
               "paddle_tpu/ops/pallas/flash_attention_packed.py:575"),
    "K-BDQ": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:134"),
    "K-BDKV": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
               "paddle_tpu/ops/pallas/flash_attention.py:188"),
}


def log(*a):
    print(*a, flush=True)


def require(cond, what) -> None:
    """A check of this run that raises (an ``assert`` vanishes under
    ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def peaks_for(name: str) -> dict:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(fn, iters=30, warmup=5) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def bound_ms(nbytes: float, flops: float, dtype, peaks) -> tuple:
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks["bf16" if dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2: kernels against their plain versions --------------------------

def check_dec(rng, dtype, nh, nh_kv, d, peaks, timed):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    b, ps, maxp = 32, 16, 64
    n_pages = 1 + b * maxp
    lens = rng.randint(1, maxp * ps + 1, size=b)
    lens[0], lens[1], lens[2] = 0, 1, maxp * ps   # pad row, 1, full
    pt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for r in range(b):
        n = -(-int(lens[r]) // ps)
        pt[r, :n] = perm[used:used + n]
        used += n
    dev = DEV
    q = torch.from_numpy(rng.randn(b, nh, d).astype(np.float32)).to(dev, dtype)
    kp = torch.from_numpy(rng.randn(n_pages, ps, nh_kv * d).astype(
        np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.randn(n_pages, ps, nh_kv * d).astype(
        np.float32)).to(dev, dtype)
    pt_t = torch.from_numpy(pt).to(dev)
    sl_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    out = pa.paged_decode_attention(q, kp, vp, pt_t, sl_t)
    torch.cuda.synchronize()
    ref = pa.paged_attention_ref(q.float(), kp.float(), vp.float(), pt_t, sl_t)
    err = max_err(out, ref)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ok = err <= tol and bool(torch.isfinite(out).all()) and bool(
        (out[0] == 0).all())
    log(f"  K-DEC {str(dtype)[6:]} nh={nh} nh_kv={nh_kv} d={d} B={b} "
        f"page_size={ps}: max_abs_err {err:.3e} (tol {tol}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "K-DEC disagrees with its plain version")
    res = {"max_abs_err": err}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        tok = int(lens.sum())
        nbytes = (2 * b * nh * d * elem + tok * 2 * nh_kv * d * elem
                  + int(sum(-(-int(x) // ps) for x in lens)) * 4 + b * 4)
        flops = 4.0 * d * nh * tok
        res["ms"] = time_ms(lambda: pa.paged_decode_attention(
            q, kp, vp, pt_t, sl_t))
        res["plain_ms"] = time_ms(lambda: pa.paged_attention_ref(
            q, kp, vp, pt_t, sl_t), iters=20)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        res["library_ms"] = None   # no single PyTorch call pages attention
        res["shape"] = (f"B={b} nh={nh} nh_kv={nh_kv} d={d} page_size={ps} "
                        f"tokens={tok} {str(dtype)[6:]}")
    return res


def segments(rng, t, n_seg):
    """~n_seg segments of mixed length filling ~92% of t, -1 pad tail."""
    real = int(t * 0.92)
    cuts = np.sort(rng.choice(np.arange(1, real), n_seg - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [real]])
    seg = np.full((1, t), -1, np.int32)
    for i in range(n_seg):
        seg[0, bounds[i]:bounds[i + 1]] = i
    return seg


def visible_pairs_seg(seg) -> int:
    """Causal pairs within one segment id, summed over the rows of a
    ``(B, S)`` array whose ids each fill one run of a row."""
    return int(sum(c * (c + 1) // 2 for row in seg
                   for c in np.unique(row, return_counts=True)[1]))


FIELDS = ("tokens", "labels", "segment_ids", "positions")


def packed_rows(seed, b, s, lo, hi, vocab):
    """``b`` rows packed by the port's ``pack_documents`` from documents
    of lengths uniform in [lo, hi] (random tokens, numpy ``seed``), drawn
    until they would fill ``b * s`` slots. Returns the rows' ``(tokens,
    labels, segment_ids, positions)`` as ``(b, s)`` int32 arrays and
    their packing efficiency."""
    rng = np.random.RandomState(seed)
    docs, total = [], 0
    while total < b * s:
        n = rng.randint(lo, hi + 1)
        docs.append(rng.randint(0, vocab, n).astype(np.int32))
        total += n
    rows = pack_documents(docs, s)[:b]
    require(len(rows) == b, f"{len(docs)} documents packed into "
            f"{len(rows)} rows, not {b}")
    return (tuple(np.stack([getattr(r, f) for r in rows]) for f in FIELDS),
            packing_efficiency(rows))


def check_seg(rng, dtype, t, nh, d, peaks, timed):
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    dev = DEV
    seg = segments(rng, t, 8)
    q, k, v = (torch.from_numpy(rng.randn(1, t, nh * d).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    seg_t = torch.from_numpy(seg).to(dev)
    o, lse = fp.flash_attention_packed_segmented(q, k, v, seg_t, nh)
    torch.cuda.synchronize()
    ro, rlse = fp.segment_attention_ref(q.float(), k.float(), v.float(),
                                        seg_t, nh)
    err, lerr = max_err(o, ro), max_err(lse, rlse)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ok = (err <= tol and lerr <= 1e-3 and bool(torch.isfinite(o).all())
          and bool(torch.isfinite(lse).all()))
    log(f"  K-SEG {str(dtype)[6:]} T={t} nh={nh} d={d} 8 segments + pad: "
        f"o max_abs_err {err:.3e} (tol {tol}), lse {lerr:.3e} (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "K-SEG disagrees with its plain version")
    res = {"max_abs_err": max(err, lerr)}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        pairs = visible_pairs_seg(seg)
        nbytes = 4 * t * nh * d * elem + t * 4 + t * nh * 4
        flops = 4.0 * d * nh * pairs
        res["ms"] = time_ms(lambda: fp.flash_attention_packed_segmented(
            q, k, v, seg_t, nh))
        res["plain_ms"] = time_ms(lambda: fp.segment_attention_ref(
            q, k, v, seg_t, nh), iters=20)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        qh, kh, vh = (x.view(1, t, nh, d).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        idx = torch.arange(t, device=dev)
        mask = ((seg_t[0][:, None] == seg_t[0][None, :])
                & (idx[None, :] <= idx[:, None]))[None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                                    iters=20)
        res["shape"] = (f"T={t} nh={nh} d={d} 8 segments + pad "
                        f"(pairs={pairs}) {str(dtype)[6:]}")
    return res


def check_bshd(rng, dtype, b, s, h, d, peaks, timed):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dev = DEV
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    o, lse = fa.bshd_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ro, rlse = fa.causal_attention_ref(q.float(), k.float(), v.float())
    err, lerr = max_err(o, ro), max_err(lse, rlse)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ok = (err <= tol and lerr <= 1e-3 and bool(torch.isfinite(o).all()))
    log(f"  K-BSHD {str(dtype)[6:]} (B,S,H,D)=({b},{s},{h},{d}) causal: "
        f"o max_abs_err {err:.3e} (tol {tol}), lse {lerr:.3e} (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "K-BSHD disagrees with its plain version")
    res = {"max_abs_err": max(err, lerr)}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        pairs = b * h * s * (s + 1) // 2
        nbytes = 4 * b * s * h * d * elem + b * s * h * 4
        flops = 4.0 * d * pairs
        res["ms"] = time_ms(lambda: fa.bshd_fwd(q, k, v))
        res["plain_ms"] = time_ms(lambda: fa.causal_attention_ref(q, k, v),
                                  iters=20)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                    iters=20)
        res["shape"] = f"(B,S,H,D)=({b},{s},{h},{d}) {str(dtype)[6:]}"
    return res


def train_inputs(rng, dtype, b, s, nh, d, sk):
    """q, k, v and dO for the training kernels. With ``sk == s`` q, k, v
    are column slices of one fused ``(B, S, 3*NH*D)`` tensor, the
    layout ``gpt_block`` hands them over in (row stride 3*NH*D)."""
    hp = nh * d

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            DEV, dtype)

    if sk == s:
        qkv = randn(b, s, 3 * hp)
        q, k, v = qkv[..., :hp], qkv[..., hp:2 * hp], qkv[..., 2 * hp:]
    else:
        q, k, v = randn(b, s, hp), randn(b, sk, hp), randn(b, sk, hp)
    return q, k, v, randn(b, s, hp)


def hold(checks, dtype, label):
    """Each ``(name, ((kernel, plain), ...))`` within ``tol * max(1,
    max|plain|)``, tol 1e-4 in fp32 (fp32 sums in another order) and 1e-2
    in bf16 (outputs rounded to bf16, 2**-8 relative). Returns
    ``{name: {"max_abs_err": err}}``."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    out = {}
    for name, pairs in checks:
        err = max(max_err(x, r) / max(1.0, float(r.abs().max()))
                  for x, r in pairs)
        finite = all(bool(torch.isfinite(x).all()) for x, _ in pairs)
        ok = err <= tol and finite
        log(f"  {name} {str(dtype)[6:]} {label}: max_abs_err / max(1, "
            f"max|plain|) {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} disagrees with its plain version")
        out[name] = {"max_abs_err": err}
    return out


def time_rows(out, runs, work, lib_ms, dtype, peaks, shape):
    """Fill each row of ``out`` named in ``runs`` (``name -> (kernel,
    plain)``) with its times, bound (``work[name]`` = (bytes, FLOPs)),
    library time (``lib_ms[name]``) and shape."""
    for name, (kern, plain) in runs.items():
        r = out[name]
        r["ms"] = time_ms(kern)
        r["plain_ms"] = time_ms(plain, iters=10)
        r["bound_ms"], r["bound_by"] = bound_ms(*work[name], dtype, peaks)
        r["library_ms"] = lib_ms[name]
        r["shape"] = shape
    return out


def sdpa_ms(qh, kh, vh, doh, **kw):
    """SDPA's forward and its backward through autograd (dQ, dK and dV in
    one call), ms, on ``(B, H, S, D)`` copies."""
    qh, kh, vh = (x.detach().requires_grad_() for x in (qh, kh, vh))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), iters=20)
    oh = sdpa(qh, kh, vh, **kw)
    bwd = time_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                              retain_graph=True), iters=20)
    return fwd, bwd


def check_train(rng, dtype, b, s, nh, d, peaks, timed, causal=True,
                sk=None):
    """K-PACK, K-DQ and K-DKV against their plain versions on the same
    inputs; the backward pair both take the kernel forward's lse and
    delta. Tolerance as ``hold``."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    sk = sk or s
    q, k, v, do = train_inputs(rng, dtype, b, s, nh, d, sk)
    o, lse = fp.packed_fwd(q, k, v, nh, causal=causal)
    delta = (do.float() * o.float()).reshape(b, s, nh, d).sum(-1)
    dq = fp.packed_dq(q, k, v, do, lse, delta, nh, causal=causal)
    dk, dv = fp.packed_dkv(q, k, v, do, lse, delta, nh, causal=causal)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fp.packed_attention_ref(qf, kf, vf, nh, causal=causal)
    rdq = fp.packed_dq_ref(qf, kf, vf, dof, lse, delta, nh, causal=causal)
    rdk, rdv = fp.packed_dkv_ref(qf, kf, vf, dof, lse, delta, nh,
                                 causal=causal)
    out = hold((("K-PACK", ((o, ro), (lse, rlse))), ("K-DQ", ((dq, rdq),)),
                ("K-DKV", ((dk, rdk), (dv, rdv)))), dtype,
               f"B={b} Sq={s} Sk={sk} nh={nh} d={d} "
               f"{'causal' if causal else 'full'}")
    if not timed:
        return out
    elem = torch.finfo(dtype).bits // 8
    pairs = b * nh * (s * (s + 1) // 2 if causal else s * sk)
    act = b * s * nh * d * elem           # one (B, S, NH*D) operand
    row = b * s * nh * 4                  # one (B, S, NH) fp32 operand
    work = {"K-PACK": (4 * act + row, 4.0 * d * pairs),
            "K-DQ": (5 * act + 2 * row, 6.0 * d * pairs),
            "K-DKV": (6 * act + 2 * row, 8.0 * d * pairs)}
    runs = {
        "K-PACK": (lambda: fp.packed_fwd(q, k, v, nh, causal=causal),
                   lambda: fp.packed_attention_ref(q, k, v, nh,
                                                   causal=causal)),
        "K-DQ": (lambda: fp.packed_dq(q, k, v, do, lse, delta, nh,
                                      causal=causal),
                 lambda: fp.packed_dq_ref(q, k, v, do, lse, delta, nh,
                                          causal=causal)),
        "K-DKV": (lambda: fp.packed_dkv(q, k, v, do, lse, delta, nh,
                                        causal=causal),
                  lambda: fp.packed_dkv_ref(q, k, v, do, lse, delta, nh,
                                            causal=causal)),
    }
    qh, kh, vh, doh = (x.reshape(b, x.shape[1], nh, d).transpose(1, 2)
                       .contiguous() for x in (q, k, v, do))
    # SDPA's backward computes dQ, dK and dV in one call: its time stands
    # beside both backward kernels
    lib_fwd, lib_bwd = sdpa_ms(qh, kh, vh, doh, is_causal=causal)
    shape = (f"B={b} Sq={s} Sk={sk} nh={nh} d={d} "
             f"{'causal' if causal else 'full'} (pairs={pairs}) "
             f"{str(dtype)[6:]}")
    return time_rows(out, runs, work, {"K-PACK": lib_fwd, "K-DQ": lib_bwd,
                                       "K-DKV": lib_bwd}, dtype, peaks,
                     shape)


def check_seg_train(rng, dtype, b, s, nh, d, peaks, timed):
    """K-SEG, K-SDQ and K-SDKV against their plain
    versions on ``b`` rows packed from documents of 32..1024 tokens
    (numpy seed 0; pad tails), q, k, v column slices of one fused qkv;
    the backward pair takes the kernel forward's lse and delta. Bounds
    count only the visible (same segment, causal) pairs; the library
    time is SDPA's backward with the equivalent boolean mask."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    (_, _, seg, _), eff = packed_rows(0, b, s, 32, 1024, 50304)
    seg_t = torch.from_numpy(seg).to(DEV)
    q, k, v, do = train_inputs(rng, dtype, b, s, nh, d, s)
    o, lse = fp.seg_fwd(q, k, v, seg_t, nh)
    delta = (do.float() * o.float()).reshape(b, s, nh, d).sum(-1)
    dq = fp.seg_dq(q, k, v, do, lse, delta, seg_t, nh)
    dk, dv = fp.seg_dkv(q, k, v, do, lse, delta, seg_t, nh)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fp.segment_attention_ref(qf, kf, vf, seg_t, nh)
    rdq = fp.segment_dq_ref(qf, kf, vf, dof, lse, delta, seg_t, nh)
    rdk, rdv = fp.segment_dkv_ref(qf, kf, vf, dof, lse, delta, seg_t, nh)
    pairs = visible_pairs_seg(seg)
    label = (f"B={b} S={s} nh={nh} d={d} packed ({eff:.3f} real, "
             f"pairs={pairs * nh})")
    out = hold((("K-SEG", ((o, ro), (lse, rlse))),
                ("K-SDQ", ((dq, rdq),)), ("K-SDKV", ((dk, rdk), (dv, rdv)))),
               dtype, label)
    if not timed:
        return out
    elem = torch.finfo(dtype).bits // 8
    act = b * s * nh * d * elem
    row = b * s * nh * 4
    work = {"K-SEG": (4 * act + row + b * s * 4, 4.0 * d * nh * pairs),
            "K-SDQ": (5 * act + 2 * row + b * s * 4, 6.0 * d * nh * pairs),
            "K-SDKV": (6 * act + 2 * row + b * s * 4, 8.0 * d * nh * pairs)}
    runs = {
        "K-SEG": (lambda: fp.seg_fwd(q, k, v, seg_t, nh),
                  lambda: fp.segment_attention_ref(q, k, v, seg_t, nh)),
        "K-SDQ": (lambda: fp.seg_dq(q, k, v, do, lse, delta, seg_t, nh),
                  lambda: fp.segment_dq_ref(q, k, v, do, lse, delta, seg_t,
                                            nh)),
        "K-SDKV": (lambda: fp.seg_dkv(q, k, v, do, lse, delta, seg_t, nh),
                   lambda: fp.segment_dkv_ref(q, k, v, do, lse, delta,
                                              seg_t, nh)),
    }
    qh, kh, vh, doh = (x.reshape(b, s, nh, d).transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    idx = torch.arange(s, device=DEV)
    mask = ((seg_t[:, :, None] == seg_t[:, None, :])
            & (idx[None, :] <= idx[:, None])[None])[:, None]
    lib_fwd, lib_bwd = sdpa_ms(qh, kh, vh, doh, attn_mask=mask)
    return time_rows(out, runs, work, {"K-SEG": lib_fwd, "K-SDQ": lib_bwd,
                                       "K-SDKV": lib_bwd}, dtype, peaks,
                     f"{label} {str(dtype)[6:]}")


def check_bshd_train(rng, dtype, b, s, h, d, peaks, timed):
    """K-BSHD, K-BDQ and K-BDKV against their plain versions, causal,
    with q, k, v the ``unbind`` views of one ``(B, S, 3, H, D)`` tensor
    (``GPTAttention``'s layout, row stride 3*H*D); the backward pair
    takes the kernel forward's lse and delta."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            DEV, dtype)

    q, k, v = randn(b, s, 3, h, d).unbind(2)
    do = randn(b, s, h, d)
    o, lse = fa.bshd_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.bshd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.bshd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fa.causal_attention_ref(qf, kf, vf)
    rdq = fa.bshd_dq_ref(qf, kf, vf, dof, lse, delta)
    rdk, rdv = fa.bshd_dkv_ref(qf, kf, vf, dof, lse, delta)
    pairs = b * h * s * (s + 1) // 2
    label = f"(B,S,H,D)=({b},{s},{h},{d}) causal, unbind views"
    out = hold((("K-BSHD", ((o, ro), (lse, rlse))),
                ("K-BDQ", ((dq, rdq),)), ("K-BDKV", ((dk, rdk), (dv, rdv)))),
               dtype, label)
    if not timed:
        return out
    elem = torch.finfo(dtype).bits // 8
    act = b * s * h * d * elem
    row = b * s * h * 4
    work = {"K-BSHD": (4 * act + row, 4.0 * d * pairs),
            "K-BDQ": (5 * act + 2 * row, 6.0 * d * pairs),
            "K-BDKV": (6 * act + 2 * row, 8.0 * d * pairs)}
    runs = {
        "K-BSHD": (lambda: fa.bshd_fwd(q, k, v),
                   lambda: fa.causal_attention_ref(q, k, v)),
        "K-BDQ": (lambda: fa.bshd_dq(q, k, v, do, lse, delta),
                  lambda: fa.bshd_dq_ref(q, k, v, do, lse, delta)),
        "K-BDKV": (lambda: fa.bshd_dkv(q, k, v, do, lse, delta),
                   lambda: fa.bshd_dkv_ref(q, k, v, do, lse, delta)),
    }
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd, lib_bwd = sdpa_ms(qh, kh, vh, doh, is_causal=True)
    return time_rows(out, runs, work, {"K-BSHD": lib_fwd, "K-BDQ": lib_bwd,
                                       "K-BDKV": lib_bwd}, dtype, peaks,
                     f"{label} (pairs={pairs}) {str(dtype)[6:]}")


def phase_kernels(peaks) -> dict:
    rng = np.random.RandomState(0)
    bf, f32 = torch.bfloat16, torch.float32
    out = {}
    log("[2] kernels against their plain versions")
    out["K-DEC"] = check_dec(rng, bf, 16, 16, 64, peaks, timed=True)
    for dt, nh, nh_kv, d in [(f32, 16, 16, 64), (bf, 16, 4, 64),
                             (f32, 16, 4, 64), (bf, 16, 16, 128),
                             (f32, 8, 8, 128)]:
        check_dec(rng, dt, nh, nh_kv, d, peaks, timed=False)
    out["K-SEG"] = check_seg(rng, bf, 2048, 16, 64, peaks, timed=True)
    for dt, t, d in [(f32, 2048, 64), (bf, 1000, 64), (f32, 1000, 64),
                     (bf, 1000, 128)]:
        check_seg(rng, dt, t, 16 if d == 64 else 8, d, peaks, timed=False)
    # K-BSHD at serving's prefill_batch shape (phase 5); its row is phase
    # 12's shape, below, where 3 of its 4 main-path launches are made
    prefill_batch = check_bshd(rng, bf, 4, 256, 16, 64, peaks, timed=True)
    for dt, s, h, d in [(bf, 512, 16, 64), (f32, 512, 16, 64),
                        (bf, 300, 16, 64), (f32, 300, 16, 64),
                        (bf, 300, 8, 128)]:
        check_bshd(rng, dt, 4, s, h, d, peaks, timed=False)
    # training: the main path's shape (batch 8 x 1024, GPT-345M heads)
    out.update(check_train(rng, bf, 8, 1024, 16, 64, peaks, timed=True))
    for dt, b, s, nh, d, causal, sk in [
            (f32, 8, 1024, 16, 64, True, None),
            (bf, 2, 512, 8, 128, True, None),
            (f32, 2, 512, 8, 128, True, None),
            (f32, 2, 1000, 16, 64, True, None),
            (bf, 2, 1000, 16, 64, True, None),
            (f32, 2, 300, 8, 64, False, 700),
            (bf, 2, 256, 16, 64, False, None)]:
        check_train(rng, dt, b, s, nh, d, peaks, timed=False, causal=causal,
                    sk=sk)
    # packed-sequence training (K-SDQ, K-SDKV) and the nn API (K-BSHD,
    # K-BDQ, K-BDKV) at the main path's shapes (phases 11 and 12)
    packed_train = check_seg_train(rng, bf, 8, 1024, 16, 64, peaks,
                                   timed=True)
    for dt, nh, d in [(f32, 16, 64), (bf, 8, 128), (f32, 8, 128)]:
        check_seg_train(rng, dt, 8, 1024, nh, d, peaks, timed=False)
    out.update(check_bshd_train(rng, bf, 4, 1024, 16, 64, peaks, timed=True))
    for dt, b, s, h, d in [(f32, 4, 1024, 16, 64), (bf, 8, 1024, 16, 64),
                           (bf, 4, 300, 8, 128), (f32, 4, 300, 8, 128)]:
        check_bshd_train(rng, dt, b, s, h, d, peaks, timed=False)
    # K-SEG's row is serving's prefill_packed (phase 4, most launches);
    # phase 11's shape stands beside it, as serving's does beside K-BSHD's
    for name, other in (("K-SEG", packed_train.pop("K-SEG")),
                        ("K-BSHD", prefill_batch)):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       other["max_abs_err"])
        out[name]["also"] = {k: other[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    out.update(packed_train)
    for name, row in out.items():
        for r in (row, row.get("also")):
            if r:
                log(f"  {name} at {r['shape']}: {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


# -- phases 3-5: the serving path --------------------------------------------

def build_model(device, dtype):
    return GPTForCausalLM(model_config(), device=device, dtype=dtype,
                          generator=torch.Generator().manual_seed(0)).eval()


def record_logits(sched, reqs):
    """Wrap the engine's steps to keep every request's logits rows (the
    scheduler samples from them and drops them)."""
    eng = sched.engine
    rows = {r.rid: [] for r in reqs}
    prefill, decode = eng.prefill_packed, eng.decode

    def prefill_rec(seqs, page_lists):
        out = prefill(seqs, page_lists)
        for i, pages in enumerate(page_lists):
            req = next(r for r in reqs if r.pages is pages)
            if not req.generated:
                rows[req.rid].append(out[i].copy())
        return out

    def decode_rec(tokens, pt, lens):
        runners = [r for r in sched.running if r.status == "running"]
        out = decode(tokens, pt, lens)
        for i, r in enumerate(runners):
            rows[r.rid].append(out[i].copy())
        return out

    eng.prefill_packed, eng.decode = prefill_rec, decode_rec
    return rows


def teacher_forced_check(cpu_model, prompt, generated, card_rows, what):
    """Card logits at each generated position vs a CPU full forward."""
    seq = np.concatenate([prompt, np.asarray(generated[:-1], np.int64)])
    with torch.no_grad():
        ref = cpu_model(torch.from_numpy(seq.astype(np.int64))[None])[0]
    ref = ref[len(prompt) - 1:].numpy()
    card = np.stack(card_rows)
    require(card.shape == ref.shape, (card.shape, ref.shape))
    err = float(np.abs(card - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-3
    agree = np.argmax(ref, -1) == np.asarray(generated)
    bad = int((~agree & ~near_tie).sum())
    log(f"  {what}: {len(generated)} positions, logits max_abs_err "
        f"{err:.3e} (tol 2e-3), greedy mismatches {bad}, near-ties "
        f"{int(near_tie.sum())}")
    require(err <= 2e-3, f"{what}: card logits disagree with the CPU")
    require(bad == 0, f"{what}: greedy token disagrees off a near-tie")


def phase_accuracy(counts):
    log("[3] serving accuracy, fp32: card vs teacher-forced CPU forward")
    model = build_model(DEV, torch.float32)
    cpu = build_model("cpu", torch.float32)
    cpu.load_state_dict(model.state_dict())
    rng = np.random.RandomState(3)
    vocab = model.cfg.vocab_size
    K.reset_launch_counts()
    eng = ServingEngine(model, ServingConfig(
        page_size=16, max_model_len=1024, max_batch=8,
        max_prefill_tokens=2048))
    sched = ContinuousBatchingScheduler(eng)
    reqs = [Request(rid=i, prompt=rng.randint(0, vocab, rng.randint(
        100, 301)).astype(np.int32), max_new_tokens=16) for i in range(3)]
    rows = record_logits(sched, reqs)
    for r in reqs:
        sched.submit(r)
    sched.run()
    require(all(r.status == "finished" for r in reqs),
            [r.status for r in reqs])
    require(eng.pool.in_use == 0, "leaked pages")
    for r in reqs:
        teacher_forced_check(cpu, r.prompt.astype(np.int64), r.generated,
                             rows[r.rid], f"scheduler rid {r.rid} "
                             f"(prompt {len(r.prompt)})")
    # generate(): batch prefill (K-BSHD) + decode, greedy
    ids = rng.randint(0, vocab, (2, 120)).astype(np.int64)
    gen_rows = {0: [], 1: []}
    out = model.generate(ids, max_new_tokens=8)
    geng = next(iter(model._gen_engines.values()))
    prefill, decode = geng.prefill_batch, geng.decode
    geng.prefill_batch = lambda *a: _keep(prefill(*a), gen_rows)
    geng.decode = lambda *a: _keep(decode(*a), gen_rows)
    again = model.generate(ids, max_new_tokens=8)
    geng.prefill_batch, geng.decode = prefill, decode
    require(torch.equal(out, again), "generate() is not deterministic")
    for i in range(2):
        teacher_forced_check(cpu, ids[i], out[i, 120:].tolist(),
                             gen_rows[i], f"generate row {i}")
    counts["phase3"] = K.launch_counts()
    log(f"  launches {counts['phase3']}")
    del model, cpu, eng, sched, geng
    torch.cuda.empty_cache()


def _keep(logits, rows):
    for i in rows:
        rows[i].append(logits[i].copy())
    return logits


def phase_load(model, counts) -> dict:
    log("[4] serving load, bf16: 64 requests through the scheduler")
    eng = ServingEngine(model, ServingConfig(
        page_size=16, max_model_len=1024, max_batch=32,
        max_prefill_tokens=2048, dtype=torch.bfloat16))
    log(f"  pool: {eng.kv.num_pages} pages, {eng.kv.pool_bytes() / 1e9:.3f}"
        f" GB")
    rng = np.random.RandomState(4)
    vocab = model.cfg.vocab_size
    reqs = [Request(rid=i, prompt=rng.randint(0, vocab, rng.randint(
        64, 769)).astype(np.int32), max_new_tokens=int(rng.randint(32, 129)))
            for i in range(64)]
    # warm-up outside the measured run: allocator and library load
    warm = ContinuousBatchingScheduler(eng)
    warm.submit(Request(rid=-1, prompt=reqs[0].prompt, max_new_tokens=4))
    warm.run()
    sched = ContinuousBatchingScheduler(eng)
    finite = {"ok": True}
    decode = eng.decode

    def decode_chk(*a):
        out = decode(*a)
        finite["ok"] &= bool(np.isfinite(out).all())
        return out

    eng.decode = decode_chk
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["phase4"] = K.launch_counts()
    eng.decode = decode
    require(all(r.status == "finished" for r in reqs),
            [r.status for r in reqs])
    require(all(len(r.generated) == r.max_new_tokens for r in reqs),
            "a request stopped short of its max_new_tokens")
    require(eng.pool.in_use == 0, "leaked pages")
    require(finite["ok"], "non-finite logits")
    n_dec, n_pf = len(sched.decode_tick_ms), len(sched.prefill_calls)
    require(counts["phase4"]["K-SEG"] == n_pf * LAYERS, (counts, n_pf))
    require(counts["phase4"]["K-DEC"] == n_dec * LAYERS, (counts, n_dec))
    dec_tokens = sum(len(r.generated) - 1 for r in reqs)
    pf_tokens = sum(t for _, t, _ in sched.prefill_calls)
    ticks = np.asarray(sched.decode_tick_ms)
    ttft = np.asarray([(r.t_first_token - r.t_submit) * 1e3 for r in reqs])
    m = {
        "requests": len(reqs), "wall_s": wall,
        "output_tokens": sum(len(r.generated) for r in reqs),
        "prefill_calls": n_pf, "prefill_tokens": pf_tokens,
        "decode_ticks": n_dec, "decode_tokens": dec_tokens,
        "preemptions": sum(r.preemptions for r in reqs),
        "decode_tokens_per_s": dec_tokens / (ticks.sum() / 1e3),
        "prefill_tokens_per_s": pf_tokens / (
            sum(ms for _, _, ms in sched.prefill_calls) / 1e3),
        "output_tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
        "decode_tick_ms_p50": float(np.percentile(ticks, 50)),
        "decode_tick_ms_p90": float(np.percentile(ticks, 90)),
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "launches": counts["phase4"],
    }
    log("  " + json.dumps(m))
    return m


def phase_generate(model, counts) -> dict:
    log("[5] generate(), bf16: batch 4, 256-token prompts, 64 new tokens")
    rng = np.random.RandomState(5)
    ids = rng.randint(0, model.cfg.vocab_size, (4, 256)).astype(np.int64)
    model.generate(ids[:, :32], max_new_tokens=4)     # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=64)
    wall = time.perf_counter() - t0
    counts["phase5"] = K.launch_counts()
    require(tuple(out.shape) == (4, 320), tuple(out.shape))
    require(torch.equal(out[:, :256], torch.from_numpy(ids)),
            "generate() changed the prompt")
    require(bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
            "generate() made a token outside the vocabulary")
    require(counts["phase5"]["K-BSHD"] == LAYERS, counts)
    require(counts["phase5"]["K-DEC"] == 63 * LAYERS, counts)
    m = {"wall_s": wall, "tokens_per_s": 4 * 64 / wall,
         "launches": counts["phase5"]}
    log("  " + json.dumps(m))
    return m


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run: only
    device-side events (kernels, memcpy, memset), since an aten op's
    device time repeats its kernels'."""
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    return by_kernel


def phase_profile(model, ticks=20) -> dict:
    """Opt-in: torch.profiler over ``ticks`` steady decode ticks of a
    full batch (32 requests, ~512-token contexts): wall per tick, device
    busy share, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    log(f"[6] profile: {ticks} decode ticks at batch 32, bf16")
    eng = ServingEngine(model, ServingConfig(
        page_size=16, max_model_len=1024, max_batch=32,
        max_prefill_tokens=2048, dtype=torch.bfloat16))
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.RandomState(6)
    for i in range(32):
        sched.submit(Request(rid=i, prompt=rng.randint(
            0, model.cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=ticks + 40))
    while sched.waiting:            # admit and prefill everyone first
        sched.step()
    for _ in range(5):
        sched.step()                # warm decode ticks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_ms_by_kernel(prof)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host = time.perf_counter()
    logits = np.random.RandomState(0).randn(
        32, model.cfg.vocab_size).astype(np.float32)
    for _ in range(20):
        np.argmax(logits, axis=-1)
    argmax_ms = (time.perf_counter() - host) * 1e3 / 20
    m = {"ticks": ticks, "wall_ms_per_tick": wall_ms / ticks,
         "device_busy_ms_per_tick": busy_ms / ticks,
         "device_idle_share": 1.0 - busy_ms / wall_ms,
         "host_argmax_ms": argmax_ms,
         "top_device_ms_per_tick": {k[:60]: v / ticks for k, v in top}}
    log("  " + json.dumps(m))
    return m


# -- phases 7-13: the training paths -----------------------------------------

def train_batch(rng, b, s, vocab):
    """Random tokens with labels = the tokens shifted by one."""
    seq = rng.randint(0, vocab, (b, s + 1))
    return seq[:, :-1], seq[:, 1:]


def _loss_grads(trainer, tokens, labels, extras=()):
    """``gpt_loss`` and its grads (on the CPU, by leaf path) at the
    trainer's params."""
    loss, grads = trainer.loss_and_grads(
        trainer.params, *trainer.shard_batch(tokens, labels), extras=extras)
    return float(loss), {"/".join(path): g.cpu()
                         for path, g in flatten(grads)}


def worst_grad(g_card, g_cpu):
    """The leaf whose card grad is furthest from the CPU's, as a share of
    the largest CPU grad of that leaf: ``(ratio, name)``."""
    worst, worst_leaf = 0.0, None
    for name, want in g_cpu.items():
        ratio = max_err(g_card[name], want) / float(want.abs().max())
        if ratio > worst:
            worst, worst_leaf = ratio, name
    return worst, worst_leaf


def card_vs_cpu(tcfg, batch, what) -> dict:
    """``gpt_loss`` grads on the card against the CPU's at the same
    params (every leaf within 1e-4 of its largest CPU grad, loss within
    1e-4), then 3 trainer steps per side (losses within 1e-4, grad norms
    within 1e-4 relative). ``batch`` is ``(tokens, labels)`` or, packed,
    ``(tokens, labels, segment_ids, positions)``."""
    mcfg = model_config()
    card = hybrid.HybridParallelTrainer(mcfg, tcfg)
    cpu = hybrid.HybridParallelTrainer(mcfg, tcfg, device="cpu")
    tokens, labels, *extras = batch
    seg_pos = extras or (None, None)
    loss_c, g_card = _loss_grads(card, tokens, labels,
                                 card._packed_extras(*seg_pos))
    loss_h, g_cpu = _loss_grads(cpu, tokens, labels,
                                cpu._packed_extras(*seg_pos))
    worst, worst_leaf = worst_grad(g_card, g_cpu)
    log(f"  {what}: gpt_loss card {loss_c:.6f} cpu {loss_h:.6f}; grads: "
        f"worst leaf {worst_leaf} max_abs_err / max|cpu grad| {worst:.3e} "
        f"(tol 1e-4)")
    require(abs(loss_c - loss_h) <= 1e-4, f"{what} gpt_loss: card vs CPU")
    require(worst <= 1e-4, f"{what} grads of {worst_leaf}: card vs CPU")
    steps = []
    for i in range(3):
        lc, lh = (float(t.step(tokens, labels, *extras)) for t in (card, cpu))
        nc, nh = float(card.last_grad_norm), float(cpu.last_grad_norm)
        steps.append({"loss_card": lc, "loss_cpu": lh, "gnorm_card": nc,
                      "gnorm_cpu": nh})
        log(f"  step {i + 1}: loss card {lc:.6f} cpu {lh:.6f}; grad norm "
            f"card {nc:.6f} cpu {nh:.6f}")
        require(abs(lc - lh) <= 1e-4, f"{what} step {i + 1} loss: card vs "
                "CPU")
        require(abs(nc - nh) <= 1e-4 * abs(nh),
                f"{what} step {i + 1} grad norm: card vs CPU")
    torch.cuda.synchronize()
    del card, cpu
    torch.cuda.empty_cache()
    return {"grad_worst_ratio": worst, "grad_worst_leaf": worst_leaf,
            "loss_card": loss_c, "loss_cpu": loss_h, "steps": steps}


def phase_train_accuracy(counts, batch=2, seq=256) -> dict:
    log(f"[7] training accuracy, fp32: GPT-345M, card vs CPU, {batch} x "
        f"{seq}")
    tcfg = hybrid.TrainerConfig(compute_dtype=torch.float32,
                                learning_rate=1e-3, warmup_steps=2,
                                total_steps=10)
    tokens, labels = train_batch(np.random.RandomState(0), batch, seq,
                                 model_config().vocab_size)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = card_vs_cpu(tcfg, (tokens, labels), "unpacked")
    counts["phase7"] = K.launch_counts()
    log(f"  launches {counts['phase7']}; {time.perf_counter() - t0:.1f} s")
    for name in ("K-PACK", "K-DQ", "K-DKV"):
        require(counts["phase7"][name] > 0, f"phase 7 never launched {name}")
    return m


def phase_packed_accuracy(counts, batch=2, seq=256, doc_lengths=(20, 100),
                          seed=0) -> dict:
    log(f"[10] packed training accuracy, fp32: GPT-345M, card vs CPU, "
        f"{batch} x {seq} packed")
    mcfg = model_config()
    tcfg = hybrid.TrainerConfig(compute_dtype=torch.float32,
                                learning_rate=1e-3, warmup_steps=2,
                                total_steps=10, packed_sequences=True)
    rows, eff = packed_rows(seed, batch, seq, *doc_lengths, mcfg.vocab_size)
    seg = rows[2]
    docs = [int(r.max()) + 1 for r in seg]
    log(f"  rows: documents {docs}, pad slots "
        f"{[int((r < 0).sum()) for r in seg]}, efficiency {eff:.4f}")
    require(min(docs) >= 3 and bool((seg[:, -1] == -1).all()),
            "phase 10 rows need >= 3 documents and a pad tail each")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = card_vs_cpu(tcfg, rows, "packed")
    counts["phase10"] = K.launch_counts()
    log(f"  launches {counts['phase10']}; {time.perf_counter() - t0:.1f} s")
    for name in ("K-SEG", "K-SDQ", "K-SDKV"):
        require(counts["phase10"][name] > 0,
                f"phase 10 never launched {name}")
    for name in ("K-PACK", "K-DQ", "K-DKV"):
        require(counts["phase10"][name] == 0,
                f"phase 10 launched {name} on the packed path")
    m["packing_efficiency"] = eff
    return m


def train_setup(batch=8, seq=1024, packed=False, doc_lengths=(32, 1024)):
    """Phase 8's (or, packed, phase 11's) trainer and its batch on the
    card: ``(trainer, device batch, packing efficiency)``."""
    mcfg = model_config()
    tcfg = hybrid.TrainerConfig(learning_rate=3e-4, warmup_steps=2,
                                total_steps=100, packed_sequences=packed)
    trainer = hybrid.HybridParallelTrainer(mcfg, tcfg)
    if not packed:
        tokens, labels = train_batch(np.random.RandomState(0), batch, seq,
                                     mcfg.vocab_size)
        return trainer, trainer.shard_batch(tokens, labels), 1.0
    (tokens, labels, seg, pos), eff = packed_rows(
        0, batch, seq, *doc_lengths, mcfg.vocab_size)
    return (trainer, (*trainer.shard_batch(tokens, labels),
                      *trainer._packed_extras(seg, pos)), eff)


def phase_train(counts, peaks, iters=10, batch=8, seq=1024, packed=False,
                doc_lengths=(32, 1024)) -> dict:
    tag = "phase11" if packed else "phase8"
    log(f"[{tag[5:]}] {'packed ' if packed else ''}training, bf16: "
        f"GPT-345M, {batch} x {seq}, remat, guard on")
    trainer, dev_batch, eff = train_setup(batch, seq, packed, doc_lengths)
    first = trainer.step_presharded(*dev_batch)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [trainer.step_presharded(*dev_batch) for _ in range(iters)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts[tag] = K.launch_counts()
    losses = [float(first)] + [float(x) for x in losses]
    mcfg = trainer.model_cfg
    step_ms = wall / iters * 1e3
    tok_s = batch * seq / (wall / iters)
    n = trainer.num_params()
    flops_tok = 6 * n + 12 * mcfg.num_layers * mcfg.hidden_size * seq
    m = {"batch": batch, "seq": seq, "step_ms": step_ms,
         "tokens_per_s": tok_s, "mfu": tok_s * flops_tok / peaks["bf16"],
         "flops_per_token": flops_tok, "num_params": n,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": losses, "anomaly": trainer.anomaly_state(),
         "launches": counts[tag]}
    if packed:
        m["packing_efficiency"] = eff
        m["real_tokens_per_s"] = tok_s * eff
    log("  " + json.dumps(m))
    require(all(np.isfinite(losses)), "non-finite training loss")
    if packed:
        want = {"K-SEG": 2 * LAYERS, "K-SDQ": LAYERS, "K-SDKV": LAYERS,
                "K-PACK": 0, "K-DQ": 0, "K-DKV": 0}
    else:
        require(losses[-1] < losses[0], "training loss did not fall")
        want = {"K-PACK": 2 * LAYERS, "K-DQ": LAYERS, "K-DKV": LAYERS}
    for name, per_step in want.items():
        require(counts[tag][name] == per_step * iters,
                f"{name}: {counts[tag][name]} launches in {iters} "
                f"steps, expected {per_step} per step")
    del trainer
    torch.cuda.empty_cache()
    return m


def phase_nn_train(counts, peaks, steps=3, acc_shape=(2, 256),
                   shape=(4, 1024)) -> dict:
    """The nn API: ``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` ->
    ``loss.backward()``. fp32 at ``acc_shape``: every parameter's grad on
    the card within 1e-4 of its largest CPU grad (``qkv_proj`` reached
    only through K-BSHD's backward); then bf16 ``torch.optim.AdamW``
    steps at ``shape``: finite losses, and per step one K-BSHD, K-BDQ and
    K-BDKV per layer."""
    log(f"[12] nn-API training: GPTForCausalLM + GPTPretrainingCriterion, "
        f"fp32 {acc_shape[0]} x {acc_shape[1]} card vs CPU, then bf16 "
        f"AdamW at {shape[0]} x {shape[1]}")
    rng = np.random.RandomState(12)
    vocab = model_config().vocab_size
    crit = GPTPretrainingCriterion()
    card = build_model(DEV, torch.float32).train()
    cpu = build_model("cpu", torch.float32).train()
    cpu.load_state_dict(card.state_dict())
    ids, labels = (torch.from_numpy(x) for x in train_batch(rng, *acc_shape,
                                                             vocab))
    K.reset_launch_counts()
    loss_c = crit(card(ids.to(DEV)), labels.to(DEV))
    loss_c.backward()
    torch.cuda.synchronize()
    acc_counts = K.launch_counts()
    loss_h = crit(cpu(ids), labels)
    loss_h.backward()
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    g_card = {n: p.grad.cpu() for n, p in card.named_parameters()}
    g_cpu = {n: p.grad for n, p in cpu.named_parameters()}
    require(set(g_card) == set(g_cpu) and all(
        g is not None for g in (*g_card.values(), *g_cpu.values())),
        "a parameter got no grad")
    worst, worst_leaf = worst_grad(g_card, g_cpu)
    qkv = {n: g for n, g in g_cpu.items() if "qkv_proj" in n}
    qkv_worst, qkv_leaf = worst_grad(g_card, qkv)
    log(f"  loss card {loss_c:.6f} cpu {loss_h:.6f}; grads: "
        f"worst {worst_leaf} {worst:.3e}, worst qkv_proj {qkv_leaf} "
        f"{qkv_worst:.3e} (tol 1e-4); launches {acc_counts}")
    require(abs(loss_c - loss_h) <= 1e-4, "nn-API loss: card vs CPU")
    require(worst <= 1e-4, f"nn-API grads of {worst_leaf}: card vs CPU")
    require(min(float(g.abs().max()) for g in qkv.values()) > 0,
            "qkv_proj got a zero grad")
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        require(acc_counts[name] == LAYERS, f"nn-API backward launched "
                f"{name} {acc_counts[name]} times, not {LAYERS}")
    del card, cpu
    torch.cuda.empty_cache()

    model = build_model(DEV, torch.bfloat16).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    ids, labels = (torch.from_numpy(x).to(DEV) for x in train_batch(
        rng, *shape, vocab))

    def step():
        loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    first = step()                                         # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["phase12"] = K.launch_counts()
    losses = [float(first)] + [float(x) for x in losses]
    tokens = shape[0] * shape[1]
    m = {"loss_card_fp32": loss_c, "loss_cpu_fp32": loss_h,
         "grad_worst_ratio": worst, "grad_worst_leaf": worst_leaf,
         "qkv_proj_worst_ratio": qkv_worst, "batch": shape[0],
         "seq": shape[1], "step_ms": wall / steps * 1e3,
         "tokens_per_s": tokens * steps / wall, "losses": losses,
         "launches": counts["phase12"]}
    log("  " + json.dumps(m))
    require(all(np.isfinite(losses)), "non-finite nn-API training loss")
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        require(counts["phase12"][name] == LAYERS * steps,
                f"{name}: {counts['phase12'][name]} launches in {steps} "
                f"steps, expected {LAYERS} per step")
    del model, opt
    torch.cuda.empty_cache()
    return m


# device kernel name -> what it is, first match wins; a key of several
# parts matches when every part is in the name. The SEG instantiations
# end in "true>"; K-BSHD, K-BDQ and K-BDKV launch the K-PACK, K-DQ and
# K-DKV instantiations.
KERNEL_KINDS = ((("flash_fwd_kernel", "true>"), "K-SEG"),
                (("flash_dq_kernel", "true>"), "K-SDQ"),
                (("flash_dkv_kernel", "true>"), "K-SDKV"),
                (("flash_fwd_kernel",), "K-PACK"),
                (("flash_dq_kernel",), "K-DQ"),
                (("flash_dkv_kernel",), "K-DKV"), (("nvjet",), "matmul"),
                (("gemm",), "matmul"), (("reduce_kernel",), "reduction"),
                (("elementwise",), "elementwise"), (("Memcpy",), "copy"),
                (("Memset",), "copy"), (("copy",), "copy"))


def kernel_kind(name: str) -> str:
    return next((kind for keys, kind in KERNEL_KINDS
                 if all(k in name for k in keys)), "other")


def phase_train_profile(steps=3, packed=False) -> dict:
    """Opt-in: torch.profiler over ``steps`` bf16 training steps at
    phase 8's (or, packed, phase 11's) shape: wall per step, device busy
    share, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    log(f"[{13 if packed else 9}] profile: {steps} "
        f"{'packed ' if packed else ''}training steps, bf16, 8 x 1024")
    trainer, dev_batch, _ = train_setup(packed=packed)
    for _ in range(2):
        trainer.step_presharded(*dev_batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step_presharded(*dev_batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_ms_by_kernel(prof)
    busy_ms = sum(by_kernel.values())
    by_kind = {}
    for name, ms in by_kernel.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    m = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
         "device_busy_ms_per_step": busy_ms / steps,
         "device_idle_share": 1.0 - busy_ms / wall_ms,
         "device_ms_per_step_by_kind": dict(sorted(
             by_kind.items(), key=lambda kv: -kv[1])),
         "top_device_ms_per_step": {k[:70]: v / steps for k, v in top}}
    log("  " + json.dumps(m))
    del trainer
    torch.cuda.empty_cache()
    return m


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,7,8,10,11,12",
                    help="comma-separated; 6, 9 and 13 (profiles) are "
                    "opt-in")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[0] device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; paddle_tpu_torch from "
        f"{ptt.__file__}")
    log(smi)
    peaks = peaks_for(kind)

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.last_build
    log(f"[1] build: {time.perf_counter() - t0:.2f} s "
        f"({'built' if info['built'] else 'cached'}: {info['path']})")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    kern = phase_kernels(peaks) if 2 in phases else {}
    counts = {}
    if 3 in phases:
        phase_accuracy(counts)
    e2e = {}
    if phases & {4, 5, 6}:
        model = build_model(DEV, torch.bfloat16)
        if 4 in phases:
            e2e["serving_load"] = phase_load(model, counts)
        if 5 in phases:
            e2e["generate"] = phase_generate(model, counts)
        if 6 in phases:
            e2e["profile"] = phase_profile(model)
        del model
        torch.cuda.empty_cache()
    if 7 in phases:
        e2e["train_accuracy"] = phase_train_accuracy(counts)
    if 8 in phases:
        e2e["train"] = phase_train(counts, peaks)
    if 9 in phases:
        e2e["train_profile"] = phase_train_profile()
    if 10 in phases:
        e2e["packed_accuracy"] = phase_packed_accuracy(counts)
    if 11 in phases:
        e2e["packed_train"] = phase_train(counts, peaks, packed=True)
    if 12 in phases:
        e2e["nn_train"] = phase_nn_train(counts, peaks)
    if 13 in phases:
        e2e["packed_profile"] = phase_train_profile(packed=True)
    # the main path: serving (phases 4, 5), training (7, 8), packed
    # training (10, 11) and nn-API training (12)
    main_phases = (4, 5, 7, 8, 10, 11, 12)
    main_path = {name: sum(counts.get(f"phase{p}", {}).get(name, 0)
                           for p in main_phases)
                 for name in K.KERNELS}
    if set(main_phases) <= phases:
        missing = [n for n, c in main_path.items() if c == 0]
        require(not missing, f"main path never launched {missing}")
    summary = []
    for name in K.KERNELS:
        r = kern.get(name, {})
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": main_path[name],
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"), "shape": r.get("shape"),
            **({"also": r["also"]} if "also" in r else {}),
            "pass": name in kern})
    log(json.dumps({"e2e": e2e, "launches_by_phase": counts}))
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
