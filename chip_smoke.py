#!/usr/bin/env python3
"""Drive the paddle_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 0,1,2  # device, build, kernel checks
    python3 chip_smoke.py --phases 0,1,2,14,15,16 # speculative and int8
    python3 chip_smoke.py --phases 0,1,2,19,20,21,22  # the LLaMA family
    python3 chip_smoke.py --phases 0,1,23,24  # remat policies, durability

Phases (any failure raises and exits non-zero; nothing is skipped):

0. device: require CUDA, print the card's name and power limit;
1. build: compile ``paddle_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the widths of the paths that launch it, timed with
   CUDA events (median of >= 20 runs after warm-up) beside its plain
   version, the one PyTorch library call that computes the same function
   (where one exists), its device time under the profiler (which leaves
   out the card's waits on the host) and its bound (bytes over HBM
   bandwidth or FLOPs over peak, whichever is larger, at the published
   peak of the part); the paged rows also with L2 flushed between
   launches (``cold_ms``); then, untimed, the forward and backward
   kernels in bf16 at the edges of their tiles (``check_fwd_edges``,
   ``check_bwd_edges``) and the paged kernels in bf16 and fp32 at their
   chunks' edges over poisoned page tables (``check_paged_edges``); and
   timed rows at the shapes the LLaMA phases launch (``LLAMA_ROWS``, d
   128, 32 heads);
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
13. (opt-in) profile of 3 packed training steps at phase 11's shape;
14. speculative and int8 serving accuracy, fp32: (a) 3 repetitious
    requests (prompts of 100-300 tokens, 16 new tokens) through the
    scheduler with ``SpecDecodeConfig(k=4)``, the card's logits at every
    committed position held against a teacher-forced CPU forward; (b)
    int8 KV pools: the card's engine and the port's engine on the CPU
    fed the same tokens (packed prefill, decode steps, one verify),
    logits within 1e-2, and the int8-vs-fp32-pool gap printed;
15. speculative serving load, bf16: phase 4's configuration with k=4 on
    64 repetitious requests (prompts of 64-768 tokens), then the same
    trace with speculation off; every request finishes, no page leaks,
    K-MQ launches = verify ticks x layers, K-DEC = plain ticks x layers;
    prints acceptance, tokens per verify tick, tick times and the
    decode tokens/s of both runs;
16. int8 KV serving load, bf16 weights: phase 4's trace on int8 pools,
    then phase 15's with k=4 (K-DEC8 and K-MQ8 per tick, as 15); prints
    the pool bytes against phase 4's bf16 pool;
17. (opt-in) profile of 20 verify ticks (phase 6 with k=4 on repetitious
    prompts);
18. (opt-in) profile of 3 nn-API training steps at phase 12's shape;
19. LLaMA serving accuracy, fp32: ``llama_7b()`` width, 2 layers, MHA
    and GQA-8 (random weights drawn on the card, copied to the CPU): 3
    requests through the scheduler held against a teacher-forced CPU
    forward (2e-3), the no-cache forward (K-BSHD) against the CPU's
    (2e-3), and for GQA the card's and the CPU's engines fed the same
    tokens through a packed prefill, decode steps and a k=4 verify window
    on int8 pools (1e-2, each step from the same pool bytes: K-DEC8,
    K-MQ8) and fp32 pools (2e-3: K-DEC, K-MQ);
20. LLaMA-7B serving load, bf16, 32 layers, full width: phase 4's
    configuration and trace over vocab 32000; every request finishes, no
    page leaks, K-DEC = decode ticks x 32, K-SEG = prefill calls x 32;
    then one ``prefill_batch`` of 4 prompts (K-BSHD = 32); decode
    tokens/s, tick and TTFT percentiles, prefill tokens/s, weight and
    pool bytes, peak memory;
21. LLaMA training accuracy, fp32: ``llama_7b()`` width, 2 layers,
    GQA-8, 1 x 256: ``llama_loss`` grads and 3 trainer steps card vs CPU
    (phase 7's gates), one trainer step's loss and grads under
    ``remat="names:attn_out_kernel,attn_lse,ffn_in"`` card vs CPU at the
    same gates with K-PACK launched once a layer, then
    ``LlamaForCausalLM`` + mean next-token CE + ``backward()`` card vs
    CPU (phase 12's gate; ``k_proj``/``v_proj`` grads only through
    K-BDKV);
22. LLaMA training, bf16: ``HybridParallelTrainer`` at ``llama_7b()``
    width, 8 of 32 layers, on a fixed 4 x 2048 batch, as phase 8: losses
    finite and falling, per step 16 K-PACK, 8 K-DQ and 8 K-DKV;
23. remat policies, GPT-345M: fp32 at 2 x 256, for remat False,
    ``"full"``, ``"dots"`` and ``"names:attn_out_kernel,attn_lse"``, the
    trainer's loss and grads on the card against the CPU's under the same
    policy (phase 7's gates) and against the card's ``remat=False`` grads
    (<= 1e-6 of each leaf's largest); then ``bench.py``'s configuration
    (bf16, lr 1e-4, warmup 10, total 1000, 56 x 1024) under True,
    ``"dots"``, ``names:`` and ``names:`` with ``ffn_in`` (the fc_in
    product saved), 1 warm-up and 5 timed steps each: step ms, tokens/s,
    MFU, peak memory, launches per step (K-PACK 24 under both ``names:``
    policies, 48 under True and ``"dots"``);
24. durability drills: (a) GPT-345M bf16 with ``loss_scaling=True``,
    ``scale_incr_every=2`` and a NaN at step 3: the scale follows its
    schedule and the losses equal, bitwise, a clean run that skips that
    batch, and the grads autograd returns under the scale are the plain
    grads times it (<= 1e-6 of each leaf's largest); (b) a sync and an async checkpoint of the full GPT-345M train
    state (bytes, save, snapshot, commit and load ms), and a fresh
    trainer that loads it gives the next 3 losses bitwise; (c) a worker
    process (2 layers at GPT-345M width, async saves every 2 steps) is
    preempted by ``PADDLE_FI_PREEMPT_AT_STEP=3``, exits 118 with a
    just-in-time checkpoint that verifies, and its relaunch resumes at
    step 3 and ends with the params of an uninterrupted 6-step run,
    bitwise; (d) two NaN steps in a row under ``max_consecutive_skips=2``
    raise ``NumericalDivergenceError`` rolled back to the last checkpoint,
    whose params the trainer then holds.

Each main-path phase (3-5, 7, 8, 10-12, 14-16, 19-24) sets the kernels' launch
counts to 0 just before it and reads them just after. The line before the
last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.io.packing import pack_documents, packing_efficiency
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_345m)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.parallel import hybrid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      NgramDrafter, Request, ServingConfig,
                                      ServingEngine, SpecDecodeConfig,
                                      repetitious_trace)
from paddle_tpu_torch.utils.tree import flatten, tree_map

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


def llama_config(**kw):
    """LLaMA-7B at its published widths (``llama_7b()``: hidden 4096, 32
    heads of 128, FFN 11008, vocab 32000); ``num_layers`` cuts the
    depth, ``num_kv_heads`` makes it GQA."""
    return llama_7b(**kw)


def llama_model(cfg, device, dtype, seed):
    """A LLaMA model with random weights drawn on ``device`` itself."""
    return LlamaForCausalLM(cfg, device=device, dtype=dtype,
                            generator=torch.Generator(device=device)
                            .manual_seed(seed)).eval()
SOURCES = {
    "K-DEC": ("paddle_tpu_torch/csrc/paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:70"),
    "K-DEC8": ("paddle_tpu_torch/csrc/paged_attention.cu",
               "paddle_tpu/ops/pallas/paged_attention.py:70"),
    "K-MQ": ("paddle_tpu_torch/csrc/paged_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:309"),
    "K-MQ8": ("paddle_tpu_torch/csrc/paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:309"),
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


def cold_ms(fn, iters=20, warmup=3) -> float:
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    each run by writing a 128 MB buffer (the H100's L2 holds 50 MB): a
    decode tick reads each layer's own pools cold. The flush is outside
    the events, and a spin of ~0.5 ms after it keeps the card busy while
    the host enqueues ``fn``, so the events time the kernels and not the
    host."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one ``fn`` call under torch.profiler: the kernels
    it launched, summed, per call. Beside ``time_ms``'s CUDA-event time,
    which also counts the gaps where the card waits on the host, it
    shows whether a call is bound by its kernel or by its host work."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(device_ms_by_kernel(prof).values()) / iters


def bound_ms(nbytes: float, flops: float, dtype, peaks) -> tuple:
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks["bf16" if dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2: kernels against their plain versions --------------------------

def check_dec(rng, dtype, nh, nh_kv, d, peaks, timed, qlen=None,
              int8=False, lens=None, page_size=16, max_pages=64,
              poison=False):
    """K-DEC (``qlen`` None: one query row) or K-MQ (a verify window of
    ``qlen`` rows) against its plain version at serving's decode shape;
    ``int8``: int8 pools with per-page scales (K-DEC8, K-MQ8) read by a
    ``dtype`` query. ``lens`` (else 32 drawn, the first three 0, 1 and
    the whole table) may run past the table; ``poison``: the kernel's
    table holds a page id far past the pool in every slot its request
    does not reach, so a read there faults (the plain version, which
    gathers the whole table, gets zeros there)."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    name = ("K-DEC" if qlen is None else "K-MQ") + ("8" if int8 else "")
    ps, maxp = page_size, max_pages
    if lens is None:
        b = 32
        lens = rng.randint(1, maxp * ps + 1, size=b)
        lens[0], lens[1], lens[2] = 0, 1, maxp * ps   # pad row, 1, full
    else:
        lens = np.asarray(lens)
        b = len(lens)
    n_pages = 1 + b * maxp
    pt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for r in range(b):
        n = min(maxp, -(-max(0, int(lens[r])) // ps))
        pt[r, :n] = perm[used:used + n]
        used += n
    kern_pt = pt
    if poison:
        kern_pt = np.where(np.arange(maxp)[None, :] < -(-np.maximum(
            lens, 0)[:, None] // ps), pt, n_pages + 2 ** 24).astype(np.int32)
    dev = DEV
    rows = 1 if qlen is None else qlen
    qshape = (b, nh, d) if qlen is None else (b, qlen, nh, d)
    q = torch.from_numpy(rng.randn(*qshape).astype(np.float32)).to(dev, dtype)
    if int8:
        kp, vp = (torch.from_numpy(rng.randint(
            -127, 128, (n_pages, ps, nh_kv * d)).astype(np.int8)).to(dev)
            for _ in range(2))
        # dequantized values within ~[-3.8, 3.8], as N(0, 1) K/V would be
        sc = torch.from_numpy(rng.uniform(0.01, 0.03, (n_pages, 2, nh_kv))
                              .astype(np.float32)).to(dev)
    else:
        kp, vp = (torch.from_numpy(rng.randn(n_pages, ps, nh_kv * d).astype(
            np.float32)).to(dev, dtype) for _ in range(2))
        sc = None
    pt_t = torch.from_numpy(pt).to(dev)
    kpt_t = torch.from_numpy(kern_pt).to(dev)
    sl_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    kern, plain = ((pa.paged_decode_attention, pa.paged_attention_ref)
                   if qlen is None else (pa.paged_multiquery_attention,
                                         pa.paged_multiquery_attention_ref))
    out = kern(q, kp, vp, kpt_t, sl_t, scales=sc)
    torch.cuda.synchronize()
    pool = (lambda x: x) if int8 else (lambda x: x.float())
    ref = plain(q.float(), pool(kp), pool(vp), pt_t, sl_t, scales=sc)
    err = max_err(out, ref)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ok = err <= tol and bool(torch.isfinite(out).all()) and bool(
        (out[torch.from_numpy(lens <= 0).to(dev)] == 0).all())
    what = (f"{str(dtype)[6:]}" + (" q, int8 pools" if int8 else "")
            + ("" if qlen is None else f" qlen={qlen}"))
    log(f"  {name} {what} nh={nh} nh_kv={nh_kv} d={d} B={b} "
        f"page_size={ps} max_pages={maxp}"
        + (f" lens={lens.tolist()}" if b <= 16 else "")
        + f": max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} disagrees with its plain version")
    res = {"max_abs_err": err}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        kv_elem = 1 if int8 else elem
        tok = int(lens.sum())
        pages = int(sum(-(-int(x) // ps) for x in lens))
        # key positions each window row sees, summed over rows
        pairs = int(sum(max(0, min(int(x), int(x) - rows + r + 1))
                        for x in lens for r in range(rows)))
        nbytes = (2 * b * rows * nh * d * elem + tok * 2 * nh_kv * d * kv_elem
                  + pages * 4 + b * 4 + (pages * 2 * nh_kv * 4 if int8 else 0))
        flops = 4.0 * d * nh * pairs
        res["ms"] = time_ms(lambda: kern(q, kp, vp, pt_t, sl_t, scales=sc))
        res["device_ms"] = device_ms(lambda: kern(q, kp, vp, pt_t, sl_t,
                                                  scales=sc))
        res["cold_ms"] = cold_ms(lambda: kern(q, kp, vp, pt_t, sl_t,
                                              scales=sc))
        res["plain_ms"] = time_ms(lambda: plain(q, kp, vp, pt_t, sl_t,
                                                scales=sc), iters=20)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        res["library_ms"] = None   # no single PyTorch call pages attention
        res["shape"] = (f"B={b} nh={nh} nh_kv={nh_kv} d={d} page_size={ps} "
                        f"tokens={tok} {what}")
    return res


# check_paged_edges' cases: page sizes (256-token chunks of 32 and 8
# pages over a 640-token table), (nh, nh_kv, d), and per window length the
# lengths: chunk edges, the whole table and past it; windows whose rows
# straddle a chunk edge; and seq_len < qlen
PAGED_EDGES = {
    "tables": [(8, 80), (32, 20)],
    "heads": [(16, 16, 64), (16, 4, 64), (8, 2, 128)],
    "lens": {None: [0, 1, 255, 256, 257, 511, 512, 513, 640, 700],
             5: [0, 3, 258, 260, 514, 256, 640, 700],
             8: [0, 5, 259, 263, 515, 257, 640, 700]},
}


def check_paged_edges(dtypes=(torch.bfloat16, torch.float32),
                      poison=True) -> dict:
    """K-DEC, K-DEC8, K-MQ and K-MQ8 against their plain versions over
    ``PAGED_EDGES``, each table poisoned past its request's pages (see
    ``check_dec``; the CPU rehearsal, whose wrappers are the plain
    versions, passes ``poison=False``). Untimed, from a seed of its own so
    the timed rows keep their inputs. Returns each kernel's worst
    error."""
    rng = np.random.RandomState(5)
    worst = dict.fromkeys(("K-DEC", "K-DEC8", "K-MQ", "K-MQ8"), 0.0)
    for dtype in dtypes:
        for ps, maxp in PAGED_EDGES["tables"]:
            for nh, nh_kv, d in PAGED_EDGES["heads"]:
                for qlen, lens in PAGED_EDGES["lens"].items():
                    for int8 in (False, True):
                        name = (("K-DEC" if qlen is None else "K-MQ")
                                + ("8" if int8 else ""))
                        res = check_dec(rng, dtype, nh, nh_kv, d, None,
                                        timed=False, qlen=qlen, int8=int8,
                                        lens=lens, page_size=ps,
                                        max_pages=maxp, poison=poison)
                        worst[name] = max(worst[name], res["max_abs_err"])
    return worst


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


def check_seg(rng, dtype, t, nh, d, peaks, timed, seg=None,
              what="8 segments + pad"):
    """K-SEG against its plain version on one row of ~8 sorted segments
    and a pad tail drawn from ``rng``, or on the given ``(B, t)`` ids."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    dev = DEV
    seg = segments(rng, t, 8) if seg is None else seg
    q, k, v = (torch.from_numpy(rng.randn(len(seg), t, nh * d).astype(
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
    log(f"  K-SEG {str(dtype)[6:]} B={len(seg)} T={t} nh={nh} d={d} {what}: "
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
        res["device_ms"] = device_ms(
            lambda: fp.flash_attention_packed_segmented(q, k, v, seg_t, nh))
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
        res["device_ms"] = device_ms(lambda: fa.bshd_fwd(q, k, v))
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


def seg_edges(rng, t):
    """Three rows of segment ids of length ``t`` (>= 600) for K-SEG's edge
    checks: (0) sorted segments that start mid-tile, three single-token
    segments and an all-pad tail from 0.6 t (whole pad k-tiles); (1) runs
    whose ids are out of order, one id recurring after others, ids that
    share their low 10 bits (1023 and -1, 7 and 1031) and the int32
    extremes; (2) each token's id drawn from row 1's ids, no runs."""
    ids = np.array([5, 2, 9, 2, 1023, -1, 7, 1031, 2 ** 31 - 1, -2 ** 31, 0],
                   np.int64)
    rows = np.full((3, t), -1, np.int64)
    cuts = [0, 1, 2, 3, 50, 127, 128, 129, 200, 250, 333, 517, int(0.6 * t)]
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        rows[0, lo:hi] = i
    lens = rng.multinomial(t - len(ids), np.ones(len(ids)) / len(ids)) + 1
    rows[1] = np.repeat(ids, lens)
    rows[2] = rng.choice(ids, t)
    return rows.astype(np.int32)


def check_pack(rng, dtype, b, s, nh, d, causal=True, sk=None):
    """K-PACK's forward alone against its plain version (tolerance as
    ``hold``): causal self-attention on column slices of one fused qkv,
    or, with ``sk``, full attention of q ``(B, s)`` over k, v ``(B, sk)``."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    sk = sk or s
    q, k, v, _ = train_inputs(rng, dtype, b, s, nh, d, sk)
    o, lse = fp.packed_fwd(q, k, v, nh, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = fp.packed_attention_ref(q.float(), k.float(), v.float(), nh,
                                       causal=causal)
    return hold((("K-PACK", ((o, ro), (lse, rlse))),), dtype,
                f"B={b} Sq={s} Sk={sk} nh={nh} d={d} "
                f"{'causal' if causal else 'full'}")["K-PACK"]


def check_fwd_edges(dtype=torch.bfloat16, heads=None) -> dict:
    """The forward kernels (K-PACK, K-BSHD, K-SEG) at the edges of the
    Hopper body's tiles (128-row q-blocks, 128-key K/V tiles): S of 1, 17,
    127, 129 and 1000; full attention with Sq != Sk; the segment rows of
    ``seg_edges``; each at d 64 (16 heads) and some at d 128 (8 heads).
    Untimed, from a seed of their own so the timed rows keep their
    inputs; ``heads`` sets every head count (the CPU rehearsal). Returns
    each kernel's worst error."""
    rng = np.random.RandomState(2)
    worst = dict.fromkeys(("K-PACK", "K-BSHD", "K-SEG"), 0.0)

    def keep(name, res):
        worst[name] = max(worst[name], res["max_abs_err"])

    def nh(d):                       # GPT-345M's width, 1024
        return heads or 1024 // d

    for s, d in [(1, 64), (17, 64), (127, 64), (129, 64), (1000, 64),
                 (1, 128), (129, 128)]:
        keep("K-PACK", check_pack(rng, dtype, 2, s, nh(d), d))
        keep("K-BSHD", check_bshd(rng, dtype, 2, s, nh(d), d, None,
                                  timed=False))
    for s, sk, d in [(300, 700, 64), (128, 1024, 64), (300, 700, 128)]:
        keep("K-PACK", check_pack(rng, dtype, 2, s, nh(d), d, causal=False,
                                  sk=sk))
    for d in (64, 128):
        keep("K-SEG", check_seg(rng, dtype, 1000, nh(d), d, None,
                                timed=False, seg=seg_edges(rng, 1000),
                                what="mid-tile, single-token, unsorted, "
                                "colliding and extreme ids, pad tail"))
    return worst


# check_bwd_edges' cases: causal (S, d), full (B, Sq, Sk, d), the segment
# rows of ``seg_edges`` at each d, and (B, S, H, D) on ``unbind`` views
BWD_EDGES = {
    "causal": [(1, 64), (17, 64), (63, 64), (65, 64), (127, 64), (129, 64),
               (1000, 64), (1, 128), (129, 128)],
    "full": [(2, 300, 700, 64), (2, 128, 1024, 64), (2, 300, 700, 128)],
    "seg": [64, 128],
    "bshd": [(2, 129, 16, 64), (2, 129, 8, 128)],
}
BWD_NAMES = ("K-DQ", "K-DKV", "K-SDQ", "K-SDKV", "K-BDQ", "K-BDKV")


def check_bwd_edges(dtype=torch.bfloat16, heads=None) -> dict:
    """The backward kernels (K-DQ, K-DKV, K-SDQ, K-SDKV, K-BDQ, K-BDKV)
    at the edges of the Hopper bodies' tiles (dQ: 128-row q-blocks over
    64-key tiles; dK/dV: 64-key blocks over 64-query tiles), the cases of
    ``BWD_EDGES``: ragged S in both loops, full attention with Sq != Sk
    (every key block walks every q-tile), a last tile past the end of a
    batch (B = 2), the segment rows of ``seg_edges``, the ``unbind``
    views of (B, S, 3, H, D) (row stride 3*H*D), and operands whose base
    is not 16-byte aligned (``_rows`` copies them). Untimed, tolerance as
    ``hold``, from a seed of their own so the timed rows keep their
    inputs; ``heads`` sets every head count (the CPU rehearsal). Returns
    each kernel's worst error."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    rng = np.random.RandomState(3)
    worst = dict.fromkeys(BWD_NAMES, 0.0)

    def keep(res):
        for name, r in res.items():
            if name in worst:
                worst[name] = max(worst[name], r["max_abs_err"])

    def nh(d):                       # GPT-345M's width, 1024
        return heads or 1024 // d

    for s, d in BWD_EDGES["causal"]:
        keep(check_train(rng, dtype, 2, s, nh(d), d, None, timed=False))
    for b, s, sk, d in BWD_EDGES["full"]:
        keep(check_train(rng, dtype, b, s, nh(d), d, None, timed=False,
                         causal=False, sk=sk))
    for d in BWD_EDGES["seg"]:
        keep(check_seg_train(rng, dtype, 3, 1000, nh(d), d, None,
                             timed=False, seg=seg_edges(rng, 1000),
                             what="mid-tile, single-token, unsorted, "
                             "colliding and extreme ids, pad tail"))
    for b, s, h, d in BWD_EDGES["bshd"]:
        keep(check_bshd_train(rng, dtype, b, s, heads or h, d, None,
                              timed=False))
    # operands 2 bytes past an aligned base: the wrappers copy them
    b, s, d = 2, 129, 64
    hp = nh(d) * d
    q, k, v, do = (torch.empty(b * s * hp + 1, dtype=dtype, device=DEV)[1:]
                   .view(b, s, hp).copy_(torch.from_numpy(rng.randn(
                       b, s, hp).astype(np.float32))) for _ in range(4))
    o, lse = fp.packed_fwd(q, k, v, nh(d))
    delta = (do.float() * o.float()).reshape(b, s, nh(d), d).sum(-1)
    dq = fp.packed_dq(q, k, v, do, lse, delta, nh(d))
    dk, dv = fp.packed_dkv(q, k, v, do, lse, delta, nh(d))
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    rdq = fp.packed_dq_ref(qf, kf, vf, dof, lse, delta, nh(d))
    rdk, rdv = fp.packed_dkv_ref(qf, kf, vf, dof, lse, delta, nh(d))
    keep(hold((("K-DQ", ((dq, rdq),)), ("K-DKV", ((dk, rdk), (dv, rdv)))),
              dtype, f"B={b} S={s} nh={nh(d)} d={d} causal, unaligned "
              "bases"))
    return worst


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
        r["device_ms"] = device_ms(kern)
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


def check_seg_train(rng, dtype, b, s, nh, d, peaks, timed, seg=None,
                    what=None):
    """K-SEG, K-SDQ and K-SDKV against their plain
    versions on ``b`` rows packed from documents of 32..1024 tokens
    (numpy seed 0; pad tails), or on the given ``(b, s)`` ids (untimed),
    q, k, v column slices of one fused qkv;
    the backward pair takes the kernel forward's lse and delta. Bounds
    count only the visible (same segment, causal) pairs; the library
    time is SDPA's backward with the equivalent boolean mask."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    if seg is None:
        (_, _, seg, _), eff = packed_rows(0, b, s, 32, 1024, 50304)
        pairs = visible_pairs_seg(seg)
        what = f"packed ({eff:.3f} real, pairs={pairs * nh})"
    else:
        require(not timed, "timed rows are packed rows")
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
    label = f"B={b} S={s} nh={nh} d={d} {what}"
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


# phase 2's timed rows at the shapes the LLaMA phases launch (d 128, 32
# heads): K-DEC MHA and GQA-8 at serving's batch, K-SEG at a full packed
# prefill, K-BSHD at a 4-row prefill_batch, training's three at 4 x 2048
LLAMA_ROWS = {"dec": (32, (32, 8), 128), "seg": (2048, 32, 128),
              "bshd": (4, 1024, 32, 128), "train": (4, 2048, 32, 128)}
ROW_KEYS = ("shape", "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")


def llama_rows(peaks, rows=None) -> dict:
    """The kernels at ``LLAMA_ROWS``, timed, from a seed of their own (so
    the other rows keep their inputs): ``{name: [row, ...]}``."""
    r = rows or LLAMA_ROWS
    rng = np.random.RandomState(19)
    bf = torch.bfloat16
    out = {}

    def add(name, res):
        out.setdefault(name, []).append({k: res[k] for k in ROW_KEYS
                                         if k in res})

    nh, kvs, d = r["dec"]
    for nh_kv in kvs:
        add("K-DEC", check_dec(rng, bf, nh, nh_kv, d, peaks, timed=True))
    add("K-SEG", check_seg(rng, bf, *r["seg"], peaks, timed=True))
    add("K-BSHD", check_bshd(rng, bf, *r["bshd"], peaks, timed=True))
    for name, res in check_train(rng, bf, *r["train"], peaks,
                                 timed=True).items():
        add(name, res)
    return out


def phase_kernels(peaks) -> dict:
    rng = np.random.RandomState(0)
    bf, f32 = torch.bfloat16, torch.float32
    out = {}
    log("[2] kernels against their plain versions")
    out["K-DEC"] = check_dec(rng, bf, 16, 16, 64, peaks, timed=True)
    # the GQA case (nh 16, nh_kv 4) is timed as K-DEC's "also" row
    dec_gqa = None
    for dt, nh, nh_kv, d in [(f32, 16, 16, 64), (bf, 16, 4, 64),
                             (f32, 16, 4, 64), (bf, 16, 16, 128),
                             (f32, 8, 8, 128)]:
        gqa = (dt, nh_kv) == (bf, 4)
        res = check_dec(rng, dt, nh, nh_kv, d, peaks, timed=gqa)
        dec_gqa = res if gqa else dec_gqa
    # the verify window (K-MQ at k=4) and the int8 pools (K-DEC8, K-MQ8)
    # at K-DEC's timed shape, its lengths drawn from the same seed, then
    # fp32, GQA, qlen 1 and 8, head_dim 128 from a seed of their own, so
    # the later checks draw the shapes they drew before these existed
    for name, kw in (("K-MQ", dict(qlen=5)), ("K-DEC8", dict(int8=True)),
                     ("K-MQ8", dict(qlen=5, int8=True))):
        out[name] = check_dec(np.random.RandomState(0), bf, 16, 16, 64, peaks,
                              timed=True, **kw)
    rng_mq = np.random.RandomState(1)
    for dt, nh, nh_kv, d, qlen, i8 in [
            (f32, 16, 16, 64, 5, False), (bf, 16, 4, 64, 5, False),
            (f32, 16, 4, 64, 5, False), (bf, 16, 16, 64, 1, False),
            (f32, 16, 16, 64, 8, False), (bf, 8, 8, 128, 8, False),
            (f32, 16, 16, 64, None, True), (bf, 16, 4, 64, None, True),
            (f32, 8, 2, 128, None, True), (f32, 16, 16, 64, 5, True),
            (bf, 16, 4, 64, 8, True), (bf, 16, 16, 64, 1, True),
            (bf, 8, 8, 128, 3, True)]:
        check_dec(rng_mq, dt, nh, nh_kv, d, peaks, timed=False, qlen=qlen,
                  int8=i8)
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
    for name, err in check_fwd_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    # K-SEG's row is serving's prefill_packed (phase 4, most launches);
    # phase 11's shape stands beside it, as serving's does beside K-BSHD's
    for name, other in (("K-SEG", packed_train.pop("K-SEG")),
                        ("K-BSHD", prefill_batch), ("K-DEC", dec_gqa)):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       other["max_abs_err"])
        out[name]["also"] = {k: other[k] for k in (
            "shape", "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms") if k in other}
    out.update(packed_train)
    for name, err in check_bwd_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    for name, err in check_paged_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    for name, rows in llama_rows(peaks).items():
        out[name]["llama"] = rows
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       *(r["max_abs_err"] for r in rows))
    for name, row in out.items():
        for r in (row, row.get("also"), *row.get("llama", ())):
            if r:
                cold = (f", {r['cold_ms']:.4f} with L2 flushed"
                        if "cold_ms" in r else "")
                log(f"  {name} at {r['shape']}: {r['ms']:.4f} ms "
                    f"({r['device_ms']:.4f} on the device{cold}), plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


# -- phases 3-5: the serving path --------------------------------------------

# phase 4's serving configuration, and phase 15's repetitious trace: prompts
# of 64-768 tokens (a 16-64 token phrase tiled 4-12 times), as phase 4's
LOAD_CFG = dict(page_size=16, max_model_len=1024, max_batch=32,
                max_prefill_tokens=2048)
SPEC_TRACE = dict(phrase_lens=(16, 64), repeats=(4, 12),
                  out_tokens=(32, 128))


def build_model(device, dtype):
    return GPTForCausalLM(model_config(), device=device, dtype=dtype,
                          generator=torch.Generator().manual_seed(0)).eval()


def record_logits(sched, reqs):
    """Wrap the engine's steps to keep every request's logits rows (the
    scheduler samples from them and drops them): per request, each call's
    ``(tokens generated before it, rows)``; read them back with
    :func:`committed_rows`."""
    eng = sched.engine
    calls = {r.rid: [] for r in reqs}
    prefill = eng.prefill_packed

    def prefill_rec(seqs, page_lists):
        out = prefill(seqs, page_lists)
        for i, pages in enumerate(page_lists):
            req = next(r for r in reqs if r.pages is pages)
            if not req.generated:
                calls[req.rid].append((0, out[i][None].copy()))
        return out

    def step_rec(step):          # decode (n, vocab) or verify (n, w, vocab)
        def rec(tokens, pt, lens):
            runners = [r for r in sched.running if r.status == "running"]
            out = step(tokens, pt, lens)
            for i, r in enumerate(runners):
                calls[r.rid].append((len(r.generated), out[i].reshape(
                    -1, out.shape[-1]).copy()))
            return out
        return rec

    eng.prefill_packed = prefill_rec
    eng.decode, eng.verify = step_rec(eng.decode), step_rec(eng.verify)
    return calls


def committed_rows(req, calls):
    """The logits row behind each of ``req``'s generated tokens: a call
    made at ``g`` generated tokens gave the rows of the tokens committed
    before the next call (one for a prefill or a decode, the accepted
    prefix plus the bonus token of a verify window)."""
    marks = [g for g, _ in calls] + [len(req.generated)]
    return [row for (g, out), nxt in zip(calls, marks[1:])
            for row in out[:nxt - g]]


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
                             committed_rows(r, rows[r.rid]),
                             f"scheduler rid {r.rid} (prompt "
                             f"{len(r.prompt)})")
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


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def serve_load(model, cfg, reqs, spec, what) -> tuple:
    """Serve ``reqs`` through a fresh scheduler (``spec``: its speculative
    config) over a warmed-up engine of ``cfg``; every request must finish
    with finite logits, no page may leak, and each kernel must launch
    once per layer per tick of its kind. Returns the metrics and the
    scheduler (its engine at ``.engine``)."""
    eng = ServingEngine(model, cfg)
    warm = ContinuousBatchingScheduler(eng, spec_decode=spec)
    warm.submit(Request(rid=-1, prompt=reqs[0].prompt, max_new_tokens=8))
    warm.run()
    sched = ContinuousBatchingScheduler(eng, spec_decode=spec)
    finite = {"ok": True}
    steps = eng.decode, eng.verify

    def checked(step):
        def run(*a):
            out = step(*a)
            finite["ok"] &= bool(np.isfinite(out).all())
            return out
        return run

    eng.decode, eng.verify = (checked(f) for f in steps)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    eng.decode, eng.verify = steps
    require(all(r.status == "finished" for r in reqs),
            [r.status for r in reqs])
    require(all(len(r.generated) == r.max_new_tokens for r in reqs),
            "a request stopped short of its max_new_tokens")
    require(eng.pool.in_use == 0, "leaked pages")
    require(finite["ok"], "non-finite logits")
    n_dec, n_ver = len(sched.decode_tick_ms), len(sched.verify_ticks)
    n_pf = len(sched.prefill_calls)
    dec, mq = (("K-DEC8", "K-MQ8") if cfg.kv_dtype == "int8"
               else ("K-DEC", "K-MQ"))
    layers = model.cfg.num_layers
    require(launches[dec] == n_dec * layers, (launches, n_dec))
    require(launches[mq] == n_ver * layers, (launches, n_ver))
    require(launches["K-SEG"] == n_pf * layers, (launches, n_pf))
    vms = [v[0] for v in sched.verify_ticks]
    proposed = sum(v[2] for v in sched.verify_ticks)
    dec_tokens = sum(len(r.generated) - 1 for r in reqs)
    pf_tokens = sum(t for _, t, _ in sched.prefill_calls)
    ttft = [(r.t_first_token - r.t_submit) * 1e3 for r in reqs]
    m = {
        "requests": len(reqs), "wall_s": wall,
        "pool_bytes": eng.kv.pool_bytes(),
        "prefill_calls": n_pf, "decode_ticks": n_dec, "verify_ticks": n_ver,
        "decode_tokens": dec_tokens,
        "preemptions": sum(r.preemptions for r in reqs),
        "prefill_tokens": pf_tokens,
        "decode_tokens_per_s": dec_tokens / (
            (sum(sched.decode_tick_ms) + sum(vms)) / 1e3),
        "prefill_tokens_per_s": pf_tokens / (
            sum(ms for _, _, ms in sched.prefill_calls) / 1e3),
        "output_tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
        "decode_tick_ms_p50": pct(sched.decode_tick_ms, 50),
        "decode_tick_ms_p90": pct(sched.decode_tick_ms, 90),
        "verify_tick_ms_p50": pct(vms, 50), "verify_tick_ms_p90": pct(vms, 90),
        "acceptance_rate": (sum(v[3] for v in sched.verify_ticks) / proposed
                            if proposed else None),
        "tokens_per_verify_tick": (sum(v[1] for v in sched.verify_ticks)
                                   / n_ver if n_ver else None),
        "ttft_ms_p50": pct(ttft, 50), "launches": launches,
    }
    log(f"  {what}: " + json.dumps(m))
    return m, sched


def phase_load(model, counts) -> dict:
    log("[4] serving load, bf16: 64 requests through the scheduler")
    m, _ = serve_load(model, ServingConfig(**LOAD_CFG, dtype=torch.bfloat16),
                      load_trace(model.cfg.vocab_size), None, "plain")
    counts["phase4"] = m["launches"]
    return m


def load_trace(vocab, n=64, prompt=(64, 768), new_tokens=(32, 128)):
    """Phase 4's requests (numpy seed 4): prompts and new tokens uniform
    in the inclusive ranges."""
    rng = np.random.RandomState(4)
    return [Request(rid=i, prompt=rng.randint(0, vocab, rng.randint(
        prompt[0], prompt[1] + 1)).astype(np.int32),
        max_new_tokens=int(rng.randint(new_tokens[0], new_tokens[1] + 1)))
        for i in range(n)]


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
        # a user annotation (torch.optim's "Optimizer.step#...") spans the
        # kernels it launched on the device timeline: counting it would
        # count them twice
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    return by_kernel


def phase_profile(model, ticks=20, spec=None) -> dict:
    """Opt-in: torch.profiler over ``ticks`` steady serving ticks of a
    full batch (32 requests, 512-token contexts): decode ticks (phase 6),
    or with ``spec`` verify ticks on repetitious prompts (phase 17). Wall
    per tick, device busy share, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    kind = "decode" if spec is None else f"verify (k={spec.k})"
    log(f"[{6 if spec is None else 17}] profile: {ticks} {kind} ticks at "
        "batch 32, bf16")
    eng = ServingEngine(model, ServingConfig(**LOAD_CFG,
                                             dtype=torch.bfloat16))
    sched = ContinuousBatchingScheduler(eng, spec_decode=spec)
    rng = np.random.RandomState(6)
    vocab = model.cfg.vocab_size
    for i in range(32):
        prompt = (rng.randint(0, vocab, 512) if spec is None
                  else np.tile(rng.randint(0, vocab, 32), 16))
        sched.submit(Request(rid=i, prompt=prompt.astype(np.int32),
                             max_new_tokens=(ticks + 40) * (
                                 1 if spec is None else spec.k + 1)))
    while sched.waiting:            # admit and prefill everyone first
        sched.step()
    for _ in range(5):
        sched.step()                # warm ticks
    torch.cuda.synchronize()
    n_ver = len(sched.verify_ticks)
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
    by_kind = {}
    for name, ms in by_kernel.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / ticks
    host = time.perf_counter()
    logits = np.random.RandomState(0).randn(
        32 * (1 if spec is None else spec.k + 1),
        model.cfg.vocab_size).astype(np.float32)
    for _ in range(20):
        np.argmax(logits, axis=-1)
    argmax_ms = (time.perf_counter() - host) * 1e3 / 20
    m = {"ticks": ticks, "verify_ticks": len(sched.verify_ticks) - n_ver,
         "wall_ms_per_tick": wall_ms / ticks,
         "device_busy_ms_per_tick": busy_ms / ticks,
         "device_idle_share": 1.0 - busy_ms / wall_ms,
         "host_argmax_ms": argmax_ms,
         "device_ms_per_tick_by_kind": dict(sorted(
             by_kind.items(), key=lambda kv: -kv[1])),
         "top_device_ms_per_tick": {k[:60]: v / ticks for k, v in top}}
    log("  " + json.dumps(m))
    return m


# -- phases 14-17: speculative decoding and int8 KV pools --------------------

def phase_spec_accuracy(counts, serving=None, n_req=3,
                        trace=(20, 50, 5, 6, 16), decode_steps=6) -> dict:
    """(a) speculative decoding on fp32 pools against a teacher-forced CPU
    forward at every committed position; (b) int8 pools, the card's
    engine against the port's engine on the CPU fed the same tokens."""
    log("[14] speculative and int8 serving accuracy, fp32")
    serving = serving or dict(page_size=16, max_model_len=1024,
                              max_batch=8, max_prefill_tokens=2048)
    model = build_model(DEV, torch.float32)
    cpu = build_model("cpu", torch.float32)
    cpu.load_state_dict(model.state_dict())
    vocab = model.cfg.vocab_size
    plo, phi, rlo, rhi, new = trace     # prompts of plo*rlo..phi*rhi tokens
    K.reset_launch_counts()
    eng = ServingEngine(model, ServingConfig(**serving))
    sched = ContinuousBatchingScheduler(eng,
                                        spec_decode=SpecDecodeConfig(k=4))
    reqs = repetitious_trace(n_req, seed=14, vocab_size=vocab,
                             phrase_lens=(plo, phi), repeats=(rlo, rhi),
                             out_tokens=(new, new))
    calls = record_logits(sched, reqs)
    for r in reqs:
        sched.submit(r)
    sched.run()
    require(all(r.status == "finished" for r in reqs),
            [r.status for r in reqs])
    require(eng.pool.in_use == 0, "leaked pages")
    accepted = sum(r.spec_accepted for r in reqs)
    require(sched.verify_ticks and accepted > 0,
            "speculation never engaged: the check is vacuous")
    for r in reqs:
        teacher_forced_check(cpu, r.prompt.astype(np.int64), r.generated,
                             committed_rows(r, calls[r.rid]),
                             f"spec rid {r.rid} (prompt {len(r.prompt)})")
    counts["phase14"] = K.launch_counts()
    require(counts["phase14"]["K-MQ"] == len(sched.verify_ticks) * LAYERS,
            counts["phase14"])
    m = {"verify_ticks": len(sched.verify_ticks), "accepted": accepted,
         "proposed": sum(r.spec_proposed for r in reqs)}

    # (b) int8 pools: card and CPU engines get the same tokens (the
    # card's choices) through a packed prefill, decode steps and a verify
    rng = np.random.RandomState(14)
    seqs = [rng.randint(0, vocab, rng.randint(plo * rlo, phi * rhi + 1))
            .astype(np.int32) for _ in range(n_req)]
    engs = {"card": ServingEngine(model, ServingConfig(**serving,
                                                       kv_dtype="int8")),
            "cpu": ServingEngine(cpu, ServingConfig(**serving,
                                                    kv_dtype="int8")),
            "fp32": ServingEngine(model, ServingConfig(**serving))}
    outs, counts["phase14_int8"] = lockstep(engs, seqs, decode_steps, w=5,
                                            counted=("card",))
    err = max(float(np.abs(o["card"] - o["cpu"]).max()) for o in outs)
    gap = max(float(np.abs(o["card"] - o["fp32"]).max()) for o in outs)
    finite = all(np.isfinite(o["card"]).all() for o in outs)
    log(f"  int8 pools, {n_req} requests: prefill, {decode_steps} decode "
        f"steps and a verify of 5: card vs CPU logits max_abs_err "
        f"{err:.3e} (tol 1e-2); int8 vs fp32 pools on the card {gap:.3e}")
    require(finite and err <= 1e-2, "int8 card logits disagree with the CPU")
    require(counts["phase14_int8"]["K-DEC8"] == decode_steps * LAYERS
            and counts["phase14_int8"]["K-MQ8"] == LAYERS,
            counts["phase14_int8"])
    m.update(int8_card_vs_cpu=err, int8_vs_fp32_gap=gap)
    log("  " + json.dumps(m))
    del model, cpu, eng, sched, engs
    torch.cuda.empty_cache()
    return m


def lockstep(engs, seqs, decode_steps, w, counted, shared=()) -> tuple:
    """Step every engine of ``engs`` (name -> engine, the same serving
    configuration) through the same tokens, the first engine's greedy
    choices: one packed prefill of ``seqs``, ``decode_steps`` decode
    steps, then one verify window of ``w`` tokens drafted by
    ``NgramDrafter(k=w - 1)``, as ``SpecDecodeConfig(k=w - 1)`` verifies.
    ``shared`` names ``(dst, src)`` engine pairs: before every step
    ``dst``'s pools (and int8 scales) become a copy of ``src``'s, so the
    two read the same bytes and differ only in what the step writes.
    Returns each step's logits by engine and the launches made by the
    engines named in ``counted``."""
    first = next(iter(engs))
    ps = engs[first].kv.page_size
    pages = {k: [e.pool.allocate(-(-(len(x) + decode_steps + w) // ps))
                 for x in seqs] for k, e in engs.items()}
    require(all(p == pages[first] for p in pages.values()), pages)
    n = len(seqs)
    pt = np.zeros((n, engs[first].max_pages_per_seq), np.int32)
    for i, pg in enumerate(pages[first]):
        pt[i, :len(pg)] = pg
    launches = dict.fromkeys(K.KERNELS, 0)

    def step(name, *args):
        for dst, src in shared:
            a, b = engs[dst].kv, engs[src].kv
            for d, s in zip(a.k_stores + a.v_stores + (a.s_stores or []),
                            b.k_stores + b.v_stores + (b.s_stores or [])):
                d.copy_(s)
        out = {}
        for k, e in engs.items():
            before = K.launch_counts()
            out[k] = getattr(e, name)(*args)
            if k in counted:
                for kern, c in K.launch_counts().items():
                    launches[kern] += c - before[kern]
        return out

    outs = [step("prefill_packed", seqs, pages[first])]
    lens = np.asarray([len(x) for x in seqs], np.int32)
    ctx = [list(x) for x in seqs]
    for _ in range(decode_steps):
        tok = np.argmax(outs[-1][first], -1).astype(np.int32)
        for i in range(n):
            ctx[i].append(int(tok[i]))
        outs.append(step("decode", tok, pt, lens))
        lens = lens + 1
    tok = np.argmax(outs[-1][first], -1).astype(np.int32)
    win = np.zeros((n, w), np.int32)
    drafter = NgramDrafter(k=w - 1)
    for i in range(n):
        d = drafter.propose(ctx[i] + [int(tok[i])], w - 1)
        win[i, 0], win[i, 1:1 + len(d)] = tok[i], d
    outs.append(step("verify", win, pt, lens))
    for k, e in engs.items():
        for pg in pages[k]:
            e.pool.free(pg)
    return outs, launches


def phase_spec_load(model, counts, n_req=64, serving=None,
                    trace=None) -> dict:
    """Phase 4's configuration with ``SpecDecodeConfig(k=4)`` on 64
    repetitious requests, then the same trace with speculation off."""
    log(f"[15] speculative serving load, bf16: {n_req} repetitious "
        "requests, k=4, then speculation off")
    cfg = ServingConfig(**(serving or LOAD_CFG), dtype=torch.bfloat16)
    trace = trace or SPEC_TRACE

    def reqs():
        return repetitious_trace(n_req, seed=15,
                                 vocab_size=model.cfg.vocab_size, **trace)

    spec, s_sched = serve_load(model, cfg, reqs(), SpecDecodeConfig(k=4),
                               "speculative")
    counts["phase15"] = spec["launches"]
    plain, p_sched = serve_load(model, cfg, reqs(), None, "plain")
    counts["phase15_plain"] = plain["launches"]
    got = {r.rid: r.generated for r in s_sched.finished}
    same = sum(got[r.rid] == r.generated for r in p_sched.finished)
    m = {"spec": spec, "plain": plain, "identical_streams": same,
         "decode_tokens_per_s_ratio": (spec["decode_tokens_per_s"]
                                       / plain["decode_tokens_per_s"])}
    log(f"  acceptance {spec['acceptance_rate']}, tokens per verify tick "
        f"{spec['tokens_per_verify_tick']}, decode tokens/s "
        f"{spec['decode_tokens_per_s']:.1f} vs "
        f"{plain['decode_tokens_per_s']:.1f} plain "
        f"(x{m['decode_tokens_per_s_ratio']:.3f}), {same} of {n_req} "
        "streams byte-identical (bf16: reported, not required)")
    return m


def phase_int8_load(model, counts, n_req=64, serving=None, trace=None,
                    prompt=(64, 768), new_tokens=(32, 128)) -> dict:
    """Phase 4's trace on int8 pools, then phase 15's trace with k=4 on
    int8 pools; bf16 weights."""
    log(f"[16] int8 KV serving load, bf16 weights: phase 4's {n_req} "
        "requests, then phase 15's with k=4")
    serving = serving or LOAD_CFG
    cfg = ServingConfig(**serving, dtype=torch.bfloat16, kv_dtype="int8")
    plain, _ = serve_load(model, cfg, load_trace(
        model.cfg.vocab_size, n_req, prompt, new_tokens), None, "int8 plain")
    counts["phase16"] = plain["launches"]
    spec, _ = serve_load(model, cfg, repetitious_trace(
        n_req, seed=15, vocab_size=model.cfg.vocab_size,
        **(trace or SPEC_TRACE)), SpecDecodeConfig(k=4), "int8 speculative")
    counts["phase16_spec"] = spec["launches"]
    mc = model.cfg
    bf16_bytes = (2 * mc.num_layers * (cfg.max_batch * -(-cfg.max_model_len
                  // cfg.page_size) + 1) * cfg.page_size * mc.hidden_size * 2)
    m = {"plain": plain, "spec": spec, "bf16_pool_bytes": bf16_bytes,
         "pool_bytes_ratio": plain["pool_bytes"] / bf16_bytes}
    log(f"  pool {plain['pool_bytes']} bytes (scales included) against "
        f"bf16's {bf16_bytes} (x{m['pool_bytes_ratio']:.4f}); tick p50 "
        f"{plain['decode_tick_ms_p50']} ms, TTFT p50 {plain['ttft_ms_p50']} "
        f"ms, acceptance {spec['acceptance_rate']}")
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


def card_vs_cpu(tcfg, batch, what, mcfg=None, steps=None) -> dict:
    """The trainer's loss grads (``gpt_loss``, or ``llama_loss`` for a
    LLaMA ``mcfg``) on the card against the CPU's at the same params
    (every leaf within 1e-4 of its largest CPU grad, loss within 1e-4),
    then 3 trainer steps per side (losses within 1e-4, grad norms within
    1e-4 relative), on ``steps`` (3 batches) or on ``batch`` each time.
    A batch is ``(tokens, labels)`` or, packed, ``(tokens, labels,
    segment_ids, positions)``."""
    mcfg = mcfg or model_config()
    card = hybrid.HybridParallelTrainer(mcfg, tcfg)
    cpu = hybrid.HybridParallelTrainer(mcfg, tcfg, device="cpu")
    tokens, labels, *extras = batch
    seg_pos = extras or (None, None)
    loss_c, g_card = _loss_grads(card, tokens, labels,
                                 card._packed_extras(*seg_pos))
    loss_h, g_cpu = _loss_grads(cpu, tokens, labels,
                                cpu._packed_extras(*seg_pos))
    worst, worst_leaf = worst_grad(g_card, g_cpu)
    log(f"  {what}: loss card {loss_c:.6f} cpu {loss_h:.6f}; grads: "
        f"worst leaf {worst_leaf} max_abs_err / max|cpu grad| {worst:.3e} "
        f"(tol 1e-4)")
    require(abs(loss_c - loss_h) <= 1e-4, f"{what} loss: card vs CPU")
    require(worst <= 1e-4, f"{what} grads of {worst_leaf}: card vs CPU")
    log_steps = []
    for i, step_batch in enumerate(steps or [batch] * 3):
        lc, lh = (float(t.step(*step_batch)) for t in (card, cpu))
        nc, nh = float(card.last_grad_norm), float(cpu.last_grad_norm)
        log_steps.append({"loss_card": lc, "loss_cpu": lh,
                          "gnorm_card": nc, "gnorm_cpu": nh})
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
            "loss_card": loss_c, "loss_cpu": loss_h, "steps": log_steps}


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


def train_setup(batch=8, seq=1024, packed=False, doc_lengths=(32, 1024),
                mcfg=None):
    """Phase 8's (or, packed, phase 11's; with ``mcfg``, phase 22's)
    trainer and its batch on the card: ``(trainer, device batch, packing
    efficiency)``."""
    mcfg = mcfg or model_config()
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
                doc_lengths=(32, 1024), mcfg=None, tag=None,
                label="GPT-345M") -> dict:
    """``iters`` timed bf16 trainer steps after one warm-up (phases 8, 11
    and, with a LLaMA ``mcfg``, 22): losses finite (and falling
    unpacked), and per step two forward launches per layer (remat
    recomputes each) and one of each backward kernel."""
    tag = tag or ("phase11" if packed else "phase8")
    log(f"[{tag[5:]}] {'packed ' if packed else ''}training, bf16: "
        f"{label}, {batch} x {seq}, remat, guard on")
    trainer, dev_batch, eff = train_setup(batch, seq, packed, doc_lengths,
                                          mcfg)
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
    m = {"model": label, "layers": mcfg.num_layers, "batch": batch,
         "seq": seq, "step_ms": step_ms,
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
    layers = mcfg.num_layers
    if packed:
        want = {"K-SEG": 2 * layers, "K-SDQ": layers, "K-SDKV": layers,
                "K-PACK": 0, "K-DQ": 0, "K-DKV": 0}
    else:
        require(losses[-1] < losses[0], "training loss did not fall")
        want = {"K-PACK": 2 * layers, "K-DQ": layers, "K-DKV": layers}
    for name, per_step in want.items():
        require(counts[tag][name] == per_step * iters,
                f"{name}: {counts[tag][name]} launches in {iters} "
                f"steps, expected {per_step} per step")
    del trainer
    torch.cuda.empty_cache()
    return m


def nn_setup(rng, shape):
    """Phase 12's bf16 nn-API training at ``shape``: the model, its
    ``torch.optim.AdamW`` and one step on a fixed batch drawn from
    ``rng`` (the step returns the detached loss, unsynchronised)."""
    crit = GPTPretrainingCriterion()
    model = build_model(DEV, torch.bfloat16).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    ids, labels = (torch.from_numpy(x).to(DEV) for x in train_batch(
        rng, *shape, model_config().vocab_size))

    def step():
        loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return model, opt, step


def nn_grads_vs_cpu(card, cpu, ids, labels, watch, what) -> dict:
    """One fp32 forward (logits), mean next-token cross entropy
    (``GPTPretrainingCriterion``) and ``backward()`` of the same model
    on the card and on the CPU: losses within 1e-4, every parameter's
    grad on the card within 1e-4 of its largest CPU grad, and each
    parameter whose name holds a ``watch`` part with a nonzero grad (the
    attention projections whose grads flow only through the backward
    kernels). Returns the errors and the card's launches."""
    crit = GPTPretrainingCriterion()
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    before = K.launch_counts()
    loss_c = crit(card(ids.to(DEV)), labels.to(DEV))
    loss_c.backward()
    torch.cuda.synchronize()
    launches = {n: c - before[n] for n, c in K.launch_counts().items()}
    loss_h = crit(cpu(ids), labels)
    loss_h.backward()
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    g_card = {n: p.grad.cpu() for n, p in card.named_parameters()}
    g_cpu = {n: p.grad for n, p in cpu.named_parameters()}
    require(set(g_card) == set(g_cpu) and all(
        g is not None for g in (*g_card.values(), *g_cpu.values())),
        "a parameter got no grad")
    worst, worst_leaf = worst_grad(g_card, g_cpu)
    watched = {n: g for n, g in g_cpu.items() if any(w in n for w in watch)}
    w_worst, w_leaf = worst_grad(g_card, watched)
    log(f"  {what}: loss card {loss_c:.6f} cpu {loss_h:.6f}; grads: worst "
        f"{worst_leaf} {worst:.3e}, worst of {'/'.join(watch)} {w_leaf} "
        f"{w_worst:.3e} (tol 1e-4); launches {launches}")
    require(abs(loss_c - loss_h) <= 1e-4, f"{what} loss: card vs CPU")
    require(worst <= 1e-4, f"{what} grads of {worst_leaf}: card vs CPU")
    require(min(float(g.abs().max()) for g in watched.values()) > 0,
            f"{what}: a {'/'.join(watch)} weight got a zero grad")
    return {"loss_card": loss_c, "loss_cpu": loss_h,
            "grad_worst_ratio": worst, "grad_worst_leaf": worst_leaf,
            f"{'_'.join(watch)}_worst_ratio": w_worst, "launches": launches}


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
    card = build_model(DEV, torch.float32).train()
    cpu = build_model("cpu", torch.float32).train()
    cpu.load_state_dict(card.state_dict())
    ids, labels = train_batch(rng, *acc_shape, vocab)
    K.reset_launch_counts()
    acc = nn_grads_vs_cpu(card, cpu, ids, labels, ("qkv_proj",), "nn API")
    del card, cpu
    torch.cuda.empty_cache()
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        require(acc["launches"][name] == LAYERS, f"nn-API backward launched "
                f"{name} {acc['launches'][name]} times, not {LAYERS}")

    model, opt, step = nn_setup(rng, shape)
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
    m = {"loss_card_fp32": acc["loss_card"], "loss_cpu_fp32": acc["loss_cpu"],
         "grad_worst_ratio": acc["grad_worst_ratio"],
         "grad_worst_leaf": acc["grad_worst_leaf"],
         "qkv_proj_worst_ratio": acc["qkv_proj_worst_ratio"],
         "batch": shape[0],
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


# -- phases 19-22: the LLaMA family (d 128) -----------------------------------

def phase_llama_accuracy(counts, layers=2, serving=None, n_req=3,
                         prompt=(100, 300), new_tokens=16, seq=200,
                         decode_steps=6) -> dict:
    """LLaMA serving accuracy, fp32, at ``llama_7b()`` width and
    ``layers`` layers, MHA (32 kv heads) and GQA (8), random weights drawn
    on the card and carried to a CPU copy by ``load_state_dict``: (a)
    ``n_req`` requests through the scheduler, the card's logits at every
    generated position against a teacher-forced CPU forward (2e-3); (b)
    the card's no-cache forward (K-BSHD) against the CPU's (2e-3); (c)
    GQA only: the card's engines and the port's engines on the CPU fed
    the same tokens (``lockstep``: packed prefill, decode steps, one
    ``SpecDecodeConfig(k=4)`` verify window), int8 pools within 1e-2
    with the CPU engine reading the card's pool bytes at every step
    (K-DEC8, K-MQ8; a free-running CPU int8 engine is reported beside
    it), fp32 pools within 2e-3 (K-DEC, K-MQ)."""
    log(f"[19] LLaMA serving accuracy, fp32: llama_7b width, {layers} "
        "layers, MHA and GQA-8, card vs CPU")
    serving = serving or dict(page_size=16, max_model_len=1024, max_batch=8,
                              max_prefill_tokens=2048)
    k = SpecDecodeConfig(k=4).k
    K.reset_launch_counts()
    m = {}
    for name, kv in (("mha", None), ("gqa", 8)):
        cfg = llama_config(num_layers=layers, num_kv_heads=kv)
        model = llama_model(cfg, DEV, torch.float32, 19)
        cpu = LlamaForCausalLM(cfg, device="cpu").eval()
        cpu.load_state_dict(model.state_dict())
        rng = np.random.RandomState(19)
        vocab = cfg.vocab_size
        eng = ServingEngine(model, ServingConfig(**serving))
        require(eng.num_kv_heads == cfg.kv_heads, eng.num_kv_heads)
        sched = ContinuousBatchingScheduler(eng)
        reqs = [Request(rid=i, prompt=rng.randint(0, vocab, rng.randint(
            prompt[0], prompt[1] + 1)).astype(np.int32),
            max_new_tokens=new_tokens) for i in range(n_req)]
        rows = record_logits(sched, reqs)
        for r in reqs:
            sched.submit(r)
        sched.run()
        require(all(r.status == "finished" for r in reqs),
                [r.status for r in reqs])
        require(eng.pool.in_use == 0, "leaked pages")
        for r in reqs:
            teacher_forced_check(cpu, r.prompt.astype(np.int64), r.generated,
                                 committed_rows(r, rows[r.rid]),
                                 f"{name} scheduler rid {r.rid} (prompt "
                                 f"{len(r.prompt)})")
        ids = torch.from_numpy(rng.randint(0, vocab, (2, seq)))
        with torch.no_grad():
            err = max_err(model(ids.to(DEV)).cpu(), cpu(ids))
        log(f"  {name} no-cache forward (2, {seq}): logits max_abs_err "
            f"{err:.3e} (tol 2e-3)")
        require(err <= 2e-3, f"{name} no-cache forward: card vs CPU")
        m[name] = {"no_cache_err": err}
        if kv:
            # int8 codes flip where the card's and the CPU's fp32 K/V (one
            # matmul rounding apart) straddle a rounding boundary, and at
            # this width the flips move logits by ~1e-2; the gated CPU
            # engine therefore starts every step from the card's pool
            # bytes ("cpu"), the free-running one is reported ("cpu_own")
            seqs = [rng.randint(0, vocab, rng.randint(*prompt)).astype(
                np.int32) for _ in range(n_req)]
            i8 = ServingConfig(**serving, kv_dtype="int8")
            f32 = ServingConfig(**serving)
            engs = {"card": ServingEngine(model, i8),
                    "cpu": ServingEngine(cpu, i8),
                    "cpu_own": ServingEngine(cpu, i8),
                    "card_fp32": ServingEngine(model, f32),
                    "cpu_fp32": ServingEngine(cpu, f32)}
            outs, card = lockstep(engs, seqs, decode_steps, k + 1,
                                  counted=("card", "card_fp32"),
                                  shared=(("cpu", "card"),))

            def err(a, b):
                return max(max_err(torch.from_numpy(o[a]),
                                   torch.from_numpy(o[b])) for o in outs)

            e8, e8_own, e32 = (err("card", "cpu"), err("card", "cpu_own"),
                               err("card_fp32", "cpu_fp32"))
            gap = err("card", "card_fp32")
            finite = all(np.isfinite(o["card"]).all() for o in outs)
            log(f"  gqa lockstep, {n_req} requests: prefill, {decode_steps} "
                f"decode steps and a verify of {k + 1}: int8 pools card vs "
                f"CPU on the same pool bytes {e8:.3e} (tol 1e-2), on its own "
                f"pools {e8_own:.3e} (reported); fp32 pools {e32:.3e} (tol "
                f"2e-3); int8 vs fp32 pools on the card {gap:.3e}; card "
                f"launches {card}")
            require(finite and e8 <= 1e-2, "int8 card logits disagree")
            require(e32 <= 2e-3, "fp32 verify/decode logits disagree")
            for kern in ("K-DEC8", "K-DEC"):
                require(card[kern] == decode_steps * layers, (kern, card))
            for kern in ("K-MQ8", "K-MQ"):
                require(card[kern] == layers, (kern, card))
            m[name].update(int8_card_vs_cpu=e8, int8_card_vs_cpu_own=e8_own,
                           fp32_card_vs_cpu=e32, int8_vs_fp32_gap=gap)
            del engs
        del model, cpu, eng, sched
        torch.cuda.empty_cache()
    counts["phase19"] = K.launch_counts()
    for kern in ("K-SEG", "K-DEC", "K-BSHD", "K-DEC8", "K-MQ", "K-MQ8"):
        require(counts["phase19"][kern] > 0, f"phase 19 never launched {kern}")
    log(f"  launches {counts['phase19']}")
    return m


def phase_llama_load(counts, layers=None, n_req=64, serving=None,
                     prompt=(64, 768), new_tokens=(32, 128)) -> dict:
    """LLaMA-7B serving load, bf16, full width and depth (``layers``
    cuts it for the CPU rehearsal), MHA, weights drawn on the card: phase
    4's configuration and trace over vocab 32000 through ``serve_load``
    (every request finishes, no page leaks, K-DEC = decode ticks x
    layers, K-SEG = prefill calls x layers), then one ``prefill_batch``
    of the trace's 4 longest prompts (K-BSHD = layers), its last-token
    logits finite and beside a packed prefill of the same prompts."""
    cfg = llama_config(**({"num_layers": layers} if layers else {}))
    log(f"[20] LLaMA-7B serving load, bf16: {cfg.num_layers} layers, "
        f"{n_req} requests")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama_model(cfg, DEV, torch.bfloat16, 20)
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    reqs = load_trace(cfg.vocab_size, n_req, prompt, new_tokens)
    m, sched = serve_load(model, ServingConfig(**(serving or LOAD_CFG),
                                               dtype=torch.bfloat16),
                          reqs, None, "LLaMA-7B plain")
    counts["phase20"] = m["launches"]
    eng = sched.engine
    seqs = sorted((r.prompt for r in reqs), key=len)[-4:]
    ps = eng.kv.page_size
    pages = [eng.pool.allocate(-(-len(x) // ps)) for x in seqs]
    before = K.launch_counts()
    batch = eng.prefill_batch(seqs, pages)
    launches = {n: c - before[n] for n, c in K.launch_counts().items()}
    # the same prompts packed, two to a call (four exceed one call's cap)
    packed = np.concatenate([eng.prefill_packed(seqs[i:i + 2],
                                                pages[i:i + 2])
                             for i in (0, 2)])
    for pg in pages:
        eng.pool.free(pg)
    require(eng.pool.in_use == 0, "leaked pages")
    require(bool(np.isfinite(batch).all()), "non-finite prefill_batch logits")
    require(launches["K-BSHD"] == cfg.num_layers, launches)
    for n in K.KERNELS:
        counts["phase20"][n] += launches[n]
    m.update(
        model="LLaMA-7B", layers=cfg.num_layers, build_s=build_s,
        weight_bytes=weight_bytes,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        prefill_batch_shape=[len(seqs), max(len(x) for x in seqs)],
        prefill_batch_vs_packed=max_err(torch.from_numpy(batch),
                                        torch.from_numpy(packed)),
        prefill_batch_argmax_agree=int((np.argmax(batch, -1)
                                        == np.argmax(packed, -1)).sum()))
    log(f"  decode {m['decode_tokens_per_s']:.1f} tokens/s, tick p50 / p90 "
        f"{m['decode_tick_ms_p50']} / {m['decode_tick_ms_p90']} ms, TTFT "
        f"p50 {m['ttft_ms_p50']} ms, prefill "
        f"{m['prefill_tokens_per_s']:.1f} tokens/s; weights {weight_bytes} "
        f"bytes, pool {m['pool_bytes']} bytes, peak "
        f"{m['max_memory_allocated_gb']:.2f} GB; prefill_batch vs packed "
        f"{m['prefill_batch_vs_packed']:.3e}, argmax agree "
        f"{m['prefill_batch_argmax_agree']}/{len(seqs)}")
    del model, sched, eng
    torch.cuda.empty_cache()
    return m


LLAMA_NAMES = "names:attn_out_kernel,attn_lse,ffn_in"


def llama_names_step(mcfg, tcfg, batch, layers) -> dict:
    """Phase 21's step under ``LLAMA_NAMES``: the trainer's loss and grads
    card vs CPU at phase 7's gates, with K-PACK launched once a layer
    (the saved forward outputs spare the recompute its kernel)."""
    ncfg = dataclasses.replace(tcfg, remat=LLAMA_NAMES)
    card = hybrid.HybridParallelTrainer(mcfg, ncfg)
    cpu = hybrid.HybridParallelTrainer(mcfg, ncfg, device="cpu")
    before = K.launch_counts()["K-PACK"]
    loss_c, g_card = _loss_grads(card, *batch)
    kpack = K.launch_counts()["K-PACK"] - before
    loss_h, g_cpu = _loss_grads(cpu, *batch)
    worst, leaf = worst_grad(g_card, g_cpu)
    r = {"remat": LLAMA_NAMES, "loss_card": loss_c, "loss_cpu": loss_h,
         "grad_worst_ratio": worst, "grad_worst_leaf": leaf, "k_pack": kpack}
    log(f"  {json.dumps(r)}")
    require(abs(loss_c - loss_h) <= 1e-4, "phase 21 names: loss card vs CPU")
    require(worst <= 1e-4, f"phase 21 names: grads of {leaf} card vs CPU")
    require(kpack == layers, f"phase 21 names: {kpack} K-PACK launches, "
            f"expected {layers}")
    del card, cpu
    torch.cuda.empty_cache()
    return r


def phase_llama_train_accuracy(counts, layers=2, kv_heads=8, batch=1,
                               seq=256) -> dict:
    """LLaMA training accuracy, fp32, at ``llama_7b()`` width, ``layers``
    layers, GQA: (a) ``llama_loss`` grads and 3 trainer steps, card vs
    CPU (``card_vs_cpu``); (b) the nn API, ``LlamaForCausalLM`` + mean
    next-token CE + ``backward()``, card vs CPU (``nn_grads_vs_cpu``):
    ``k_proj``/``v_proj`` get their grads only through the GQA repeat and
    K-BDKV."""
    log(f"[21] LLaMA training accuracy, fp32: llama_7b width, {layers} "
        f"layers, GQA-{kv_heads}, card vs CPU, {batch} x {seq}")
    mcfg = llama_config(num_layers=layers, num_kv_heads=kv_heads)
    tcfg = hybrid.TrainerConfig(compute_dtype=torch.float32,
                                learning_rate=1e-3, warmup_steps=2,
                                total_steps=10)
    rng = np.random.RandomState(21)
    # a fresh row for each step: one AdamW step fits this 616M-parameter
    # model to a 256-token row, and the grads that remain there, each
    # gold token's probability minus one, are differences of two nearly
    # equal fp32 numbers, which the two devices round apart past the
    # grad-norm gate
    batches = [train_batch(rng, batch, seq, mcfg.vocab_size)
               for _ in range(4)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = card_vs_cpu(tcfg, batches[0], "llama_loss", mcfg, steps=batches[1:])
    m["names"] = llama_names_step(mcfg, tcfg, batches[0], layers)
    card = llama_model(mcfg, DEV, torch.float32, 21).train()
    cpu = LlamaForCausalLM(mcfg, device="cpu").train()
    cpu.load_state_dict(card.state_dict())
    nn_acc = nn_grads_vs_cpu(card, cpu, *batches[0], ("k_proj", "v_proj"),
                             "LLaMA nn API")
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        require(nn_acc["launches"][name] == layers,
                f"nn-API backward launched {name} "
                f"{nn_acc['launches'][name]} times, not {layers}")
    del card, cpu
    torch.cuda.empty_cache()
    counts["phase21"] = K.launch_counts()
    log(f"  launches {counts['phase21']}; {time.perf_counter() - t0:.1f} s")
    for name in ("K-PACK", "K-DQ", "K-DKV"):
        require(counts["phase21"][name] > 0, f"phase 21 never launched {name}")
    m["nn_api"] = nn_acc
    return m


# -- phases 23-24: the remat policies and the durability drills -------------

ACC_POLICIES = (False, "full", "dots", "names:attn_out_kernel,attn_lse")
SPEED_POLICIES = (True, "dots", "names:attn_out_kernel,attn_lse",
                  "names:attn_out_kernel,attn_lse,ffn_in")
BENCH_TRAINER = dict(learning_rate=1e-4, warmup_steps=10, total_steps=1000)


def policy_tag(remat) -> str:
    return {True: "true", False: "false", "full": "full", "dots": "dots",
            SPEED_POLICIES[-1]: "names_ffn_in"}.get(remat, "names")


def bench_setup(remat, shape=(56, 1024)):
    """A bf16 trainer at ``bench.py``'s config under ``remat`` and its
    batch on the card: random tokens and labels of ``shape`` (seed 0)."""
    mcfg = model_config()
    trainer = hybrid.HybridParallelTrainer(
        mcfg, hybrid.TrainerConfig(remat=remat, **BENCH_TRAINER))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, mcfg.vocab_size, shape)
    labs = rng.randint(0, mcfg.vocab_size, shape)
    return trainer, trainer.shard_batch(toks, labs)


def phase_remat(counts, peaks, acc=(2, 256), speed=(56, 1024),
                steps=5) -> dict:
    """Phase 23: the remat policies at GPT-345M. (a) fp32 at ``acc``: per
    policy the trainer's loss and grads on the card against the CPU's
    under the same policy (phase 7's gates) and against the card's own
    ``remat=False`` grads (<= 1e-6 of each leaf's largest); (b) bf16 at
    ``bench.py``'s config and ``speed`` batch: per policy 1 warm-up and
    ``steps`` timed steps, K-PACK 24 a step under the ``names:`` policies
    and 48 under True and ``"dots"``."""
    mcfg = model_config()
    layers = mcfg.num_layers
    log(f"[23] remat policies: GPT-345M, fp32 {acc[0]} x {acc[1]} card vs "
        f"CPU, then bf16 {speed[0]} x {speed[1]} (bench.py's config)")
    t_phase = time.perf_counter()
    tokens, labels = train_batch(np.random.RandomState(23), *acc,
                                 mcfg.vocab_size)
    out = {"accuracy": {}, "speed": {}}
    ref = None
    K.reset_launch_counts()
    for remat in ACC_POLICIES:
        tcfg = hybrid.TrainerConfig(compute_dtype=torch.float32, remat=remat)
        card = hybrid.HybridParallelTrainer(mcfg, tcfg)
        cpu = hybrid.HybridParallelTrainer(mcfg, tcfg, device="cpu")
        before = K.launch_counts()["K-PACK"]
        loss_c, g_card = _loss_grads(card, tokens, labels)
        kpack = K.launch_counts()["K-PACK"] - before
        loss_h, g_cpu = _loss_grads(cpu, tokens, labels)
        worst, leaf = worst_grad(g_card, g_cpu)
        ref = g_card if ref is None else ref
        gap, gap_leaf = worst_grad(g_card, ref)
        r = {"loss_card": loss_c, "loss_cpu": loss_h, "grad_worst_ratio":
             worst, "grad_worst_leaf": leaf, "vs_no_remat": gap,
             "vs_no_remat_bitwise": all(torch.equal(g_card[k], ref[k])
                                        for k in ref),
             "k_pack": kpack}
        log(f"  {remat!r}: {json.dumps(r)}")
        require(abs(loss_c - loss_h) <= 1e-4, f"phase 23 {remat!r} loss: "
                "card vs CPU")
        require(worst <= 1e-4, f"phase 23 {remat!r} grads of {leaf}: card "
                "vs CPU")
        require(gap <= 1e-6, f"phase 23 {remat!r} grads of {gap_leaf}: "
                "against remat=False on the card")
        want = layers if remat in (False, ACC_POLICIES[-1]) else 2 * layers
        require(kpack == want, f"phase 23 {remat!r}: {kpack} K-PACK "
                f"launches, expected {want}")
        out["accuracy"][str(remat)] = r
        del card, cpu
        torch.cuda.empty_cache()
    counts["phase23_acc"] = K.launch_counts()
    batch, seq = speed
    for remat in SPEED_POLICIES:
        tag = f"phase23_{policy_tag(remat)}"
        trainer, (t_dev, l_dev) = bench_setup(remat, speed)
        first = trainer.step_presharded(t_dev, l_dev)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [trainer.step_presharded(t_dev, l_dev)
                  for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[tag] = K.launch_counts()
        losses = [float(first)] + [float(x) for x in losses]
        n = trainer.num_params()
        flops_tok = 6 * n + 12 * layers * mcfg.hidden_size * seq
        tok_s = batch * seq / (wall / steps)
        m = {"remat": remat, "batch": batch, "seq": seq,
             "step_ms": wall / steps * 1e3, "tokens_per_s": tok_s,
             "mfu": tok_s * flops_tok / peaks["bf16"],
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "losses": losses,
             "launches_per_step": {k: counts[tag][k] / steps
                                   for k in ("K-PACK", "K-DQ", "K-DKV")}}
        log("  " + json.dumps(m))
        require(all(np.isfinite(losses)), f"phase 23 {remat!r}: non-finite "
                "loss")
        per_step = layers if remat in SPEED_POLICIES[2:] else 2 * layers
        want = {"K-PACK": per_step, "K-DQ": layers, "K-DKV": layers}
        for name, k in want.items():
            require(counts[tag][name] == k * steps,
                    f"phase 23 {remat!r}: {counts[tag][name]} {name} "
                    f"launches in {steps} steps, expected {k} a step")
        out["speed"][str(remat)] = m
        del trainer
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"  {out['s']:.1f} s")
    return out


class DrillLoader:
    """A dataloader for the drills: batch ``i`` is drawn from seed
    ``seed + i``; ``state_dict`` is its cursor, as the trainer's
    checkpoints expect of a dataloader."""

    def __init__(self, seed, batch, seq, vocab):
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab
        self.cursor = 0

    def next(self):
        out = train_batch(np.random.RandomState(self.seed + self.cursor),
                          self.batch, self.seq, self.vocab)
        self.cursor += 1
        return out

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, sd):
        self.cursor = int(sd["cursor"])


def drill_config(**kw):
    return hybrid.TrainerConfig(learning_rate=3e-4, warmup_steps=2,
                                total_steps=100, **kw)


def params_equal(a, b) -> bool:
    """Bitwise equality of two param trees (on any devices)."""
    fa, fb = dict(flatten(a)), dict(flatten(b))
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa)


def scale_schedule(cfg, steps, bad) -> list:
    """The loss scale after each of ``steps`` steps when the steps in
    ``bad`` are skipped: halved on a skip (floor 1), doubled after
    ``scale_incr_every`` finite steps in a row."""
    s, good, out = cfg.init_loss_scale, 0, []
    for i in range(1, steps + 1):
        if i in bad:
            s, good = max(s * cfg.scale_decr_ratio, 1.0), 0
        else:
            good += 1
            if good >= cfg.scale_incr_every:
                s, good = s * cfg.scale_incr_ratio, 0
        out.append(s)
    return out


def scaled_grads_gap(trainer, tokens, labels) -> tuple:
    """The grads autograd returns for ``trainer``'s loss times its loss
    scale against the plain loss's grads times the scale: (worst gap
    over each leaf's largest scaled grad, bitwise equal, the scale)."""
    seen = []
    grad = torch.autograd.grad

    def spy(*args, **kwargs):
        seen.append(grad(*args, **kwargs))
        return seen[-1]

    tok, lab = trainer.shard_batch(tokens, labels)
    scale = trainer.guard["loss_scale"]
    with mock.patch.object(torch.autograd, "grad", spy):
        trainer.loss_and_grads(trainer.params, tok, lab)
        trainer.loss_and_grads(trainer.params, tok, lab, scale=scale)
    s = float(scale)
    pairs = list(zip(seen[1], seen[0]))
    worst = max(float((a - b * s).abs().max() / a.abs().max().clamp_min(
        torch.finfo(a.dtype).tiny)) for a, b in pairs)
    return worst, all(torch.equal(a, b * s) for a, b in pairs), s


def drill_loss_scaling(counts, batch=4, seq=1024, steps=6, nan_step=3):
    """(a) ``loss_scaling=True``, ``scale_incr_every=2``, a NaN at
    ``nan_step``: the scale follows ``scale_schedule``, and every loss
    equals, bitwise, a clean run's that skips that batch; the grads
    autograd returns under the scale are the plain grads times it."""
    mcfg = model_config()
    tcfg = drill_config(loss_scaling=True, scale_incr_every=2)
    rng = np.random.RandomState(24)
    batches = [train_batch(rng, batch, seq, mcfg.vocab_size)
               for _ in range(steps)]
    K.reset_launch_counts()
    with mock.patch.dict(os.environ, PADDLE_FI_NAN_AT_STEP=str(nan_step)):
        t = hybrid.HybridParallelTrainer(mcfg, tcfg)
        losses, scales = [], []
        for b in batches:
            losses.append(float(t.step(*b)))
            scales.append(float(t.guard["loss_scale"]))
        state = t.anomaly_state()
    clean = hybrid.HybridParallelTrainer(mcfg, tcfg)
    gap, bitwise, scale = scaled_grads_gap(clean, *batches[0])
    kept = [float(clean.step(*b)) for i, b in enumerate(batches, 1)
            if i != nan_step]
    counts["phase24_scale"] = K.launch_counts()
    want = scale_schedule(tcfg, steps, {nan_step})
    got = losses[:nan_step - 1] + losses[nan_step:]
    m = {"scales": scales, "schedule": want, "losses": losses,
         "clean_losses": kept, "anomaly": state,
         "scaler": t.grad_scaler_state_dict(),
         "scaled_grads": {"scale": scale, "worst_gap": gap,
                          "bitwise": bitwise}}
    log("  (a) loss scaling: " + json.dumps(m))
    require(scales == want, "phase 24 (a): loss scale off its schedule")
    require(scale == tcfg.init_loss_scale and gap <= 1e-6, "phase 24 (a): "
            "autograd's grads are not the plain grads times the scale")
    require(not np.isfinite(losses[nan_step - 1])
            and state["skips_total"] == 1, "phase 24 (a): the NaN step was "
            "not skipped")
    require(got == kept, "phase 24 (a): losses differ from the clean run "
            "that skips the batch")
    require(params_equal(t.params, clean.params), "phase 24 (a): params "
            "differ from the clean run")
    del t, clean
    torch.cuda.empty_cache()
    return m


def drill_checkpoint(counts, batch=4, seq=1024, before=2, after=3):
    """(b) A sync save after ``before`` steps, one more step, an async
    save (two checkpoints of the full train state on disk), then a fresh
    trainer loads the newest: its next ``after`` losses equal the
    uninterrupted run's bitwise."""
    mcfg = model_config()
    tcfg = drill_config()
    loader = DrillLoader(240, batch, seq, mcfg.vocab_size)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    K.reset_launch_counts()
    try:
        t = hybrid.HybridParallelTrainer(mcfg, tcfg)
        for _ in range(before):
            t.step(*loader.next())
        t.anomaly_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_path = t.save_checkpoint(root, t.global_step, keep_last_n=2,
                                      dataloader=loader)
        sync_ms = (time.perf_counter() - t0) * 1e3
        t.step(*loader.next())
        t.anomaly_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        async_path = t.save_checkpoint(root, t.global_step, keep_last_n=2,
                                       dataloader=loader, async_save=True)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        t.flush_checkpoints()
        commit_ms = t._async_mgrs[root].last_commit_s * 1e3
        ok = [ckpt.verify_checkpoint(p) for p in (sync_path, async_path)]
        nbytes = sum(os.path.getsize(os.path.join(async_path, f))
                     for f in os.listdir(async_path))
        resume_cursor = loader.cursor
        want = [float(t.step(*loader.next())) for _ in range(after)]
        del t
        torch.cuda.empty_cache()
        fresh = hybrid.HybridParallelTrainer(mcfg, tcfg)
        loader.load_state_dict({"cursor": 0})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = fresh.load_checkpoint(root, dataloader=loader)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        got = [float(fresh.step(*loader.next())) for _ in range(after)]
        on_disk = sorted(os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts["phase24_ckpt"] = K.launch_counts()
    m = {"bytes": nbytes, "sync_save_ms": sync_ms,
         "async_snapshot_ms": snapshot_ms, "async_commit_ms": commit_ms,
         "load_ms": load_ms, "verify": ok, "on_disk": on_disk,
         "resumed_step": step, "losses": want, "resumed_losses": got}
    log("  (b) checkpoint: " + json.dumps(m))
    require(all(v[0] for v in ok), f"phase 24 (b): {ok}")
    require(step == before + 1 and loader.cursor == resume_cursor + after,
            "phase 24 (b): resumed at the wrong step or data cursor")
    require(got == want, "phase 24 (b): resumed losses differ from the "
            "uninterrupted run's")
    del fresh
    torch.cuda.empty_cache()
    return m


def drill_train(spec, root=None):
    """The preemption drill's training loop (run in a worker process, and
    uninterrupted in this one): ``spec["steps"]`` steps of a
    ``spec["model"]`` GPT on ``spec["device"]``, an async save every
    ``spec["save_every"]`` steps under ``root`` (with the preemption
    guard armed there), resuming from ``root`` when it holds a
    checkpoint. Returns ``(trainer, resumed_at)``."""
    mcfg = GPTConfig(**spec["model"])
    t = hybrid.HybridParallelTrainer(mcfg, drill_config(),
                                     device=spec["device"])
    loader = DrillLoader(2400, spec["batch"], spec["seq"], mcfg.vocab_size)
    start = 0
    if root is not None:
        t.enable_preemption_guard(root, dataloader=loader)
        start = t.load_checkpoint(root, dataloader=loader) or 0
    while t.global_step < spec["steps"]:
        t.step(*loader.next())
        if root is not None and t.global_step % spec["save_every"] == 0:
            t.save_checkpoint(root, t.global_step, dataloader=loader,
                              async_save=True)
    t.flush_checkpoints()
    return t, start


def drill_worker(spec_json: str) -> int:
    """``chip_smoke.py --drill-worker SPEC``: one generation of the
    preemption drill; writes its params to ``spec["out"]`` (``.npz``)."""
    spec = json.loads(spec_json)
    t, start = drill_train(spec, spec["root"])
    np.savez(spec["out"], **{"/".join(path): p.cpu().numpy()
                             for path, p in flatten(t.params)})
    print(json.dumps({"resumed_at": start, "global_step": t.global_step}),
          flush=True)
    return 0


def drill_preemption(counts, layers=2, batch=2, seq=512, steps=6,
                     preempt_at=3, save_every=2) -> dict:
    """(c) A worker process trains ``layers`` layers at GPT-345M width
    with async saves every ``save_every`` steps and
    ``PADDLE_FI_PREEMPT_AT_STEP``: it exits 118 with a just-in-time
    checkpoint that verifies; the relaunch resumes there, and its params
    after ``steps`` steps equal an uninterrupted run's bitwise."""
    work = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    cfg = dataclasses.replace(model_config(), num_layers=layers)
    spec = {"model": dataclasses.asdict(cfg), "device": DEV.type,
            "batch": batch, "seq": seq, "steps": steps,
            "save_every": save_every, "root": os.path.join(work, "ckpt"),
            "out": os.path.join(work, "params.npz")}
    env = dict(os.environ, PADDLE_FI_PREEMPT_AT_STEP=str(preempt_at),
               PADDLE_FI_DIR=os.path.join(work, "fi"))
    cmd = [sys.executable, os.path.abspath(__file__), "--drill-worker",
           json.dumps(spec)]
    try:
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=600)
            runs.append({"rc": p.returncode,
                         "s": time.perf_counter() - t0,
                         "stdout": p.stdout.strip()[-300:],
                         "stderr": p.stderr.strip()[-600:]})
        jit = os.path.join(spec["root"], f"step-{preempt_at}")
        jit_ok = ckpt.verify_checkpoint(jit)
        got = dict(np.load(spec["out"]))
        K.reset_launch_counts()
        ref, _ = drill_train(spec)
        want = {"/".join(path): p.cpu().numpy()
                for path, p in flatten(ref.params)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts["phase24_preempt"] = K.launch_counts()
    resumed = json.loads(runs[1]["stdout"].splitlines()[-1]) \
        if runs[1]["rc"] == 0 else None
    m = {"runs": runs, "jit_checkpoint": jit_ok, "relaunch": resumed,
         "params_bitwise": got.keys() == want.keys() and all(
             np.array_equal(got[k], want[k]) for k in want)}
    log("  (c) preemption: " + json.dumps(m))
    require(runs[0]["rc"] == hybrid.PREEMPTED_EXIT_CODE,
            f"phase 24 (c): the preempted worker exited {runs[0]['rc']}, "
            f"not {hybrid.PREEMPTED_EXIT_CODE}: {runs[0]['stderr']}")
    require(jit_ok[0], f"phase 24 (c): just-in-time checkpoint {jit_ok}")
    require(runs[1]["rc"] == 0 and resumed["resumed_at"] == preempt_at,
            f"phase 24 (c): the relaunch did not resume at {preempt_at}: "
            f"{runs[1]}")
    require(m["params_bitwise"], "phase 24 (c): params after the relaunch "
            "differ from the uninterrupted run's")
    del ref
    torch.cuda.empty_cache()
    return m


def drill_rollback(counts, layers=2, batch=2, seq=512, saved=2) -> dict:
    """(d) ``max_consecutive_skips=2`` and NaNs at two steps in a row after
    a save at step ``saved``: the trainer raises
    ``NumericalDivergenceError`` with ``rolled_back_to == saved``, and its
    params are the checkpoint's."""
    mcfg = dataclasses.replace(model_config(), num_layers=layers)
    loader = DrillLoader(2440, batch, seq, mcfg.vocab_size)
    root = tempfile.mkdtemp(prefix="chip_smoke_rollback_")
    K.reset_launch_counts()
    err = None
    try:
        t = hybrid.HybridParallelTrainer(
            mcfg, drill_config(max_consecutive_skips=2))
        for _ in range(saved):
            t.step(*loader.next())
        t.save_checkpoint(root, t.global_step)
        at_save = tree_map(lambda p: p.detach().cpu().clone(), t.params)
        bad = f"{saved + 1},{saved + 2}"
        with mock.patch.dict(os.environ, PADDLE_FI_NAN_AT_STEP=bad):
            try:
                for _ in range(4):
                    t.step(*loader.next())
                t.anomaly_state()
            except hybrid.NumericalDivergenceError as e:
                err = e
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts["phase24_rollback"] = K.launch_counts()
    m = {"raised": err is not None, "message": str(err)[:200],
         "rolled_back_to": getattr(err, "rolled_back_to", None),
         "global_step": t.global_step,
         "params_equal_checkpoint": params_equal(t.params, at_save)}
    log("  (d) rollback: " + json.dumps(m))
    require(err is not None and err.rolled_back_to == saved,
            f"phase 24 (d): no rollback to step {saved}: {m}")
    require(m["params_equal_checkpoint"] and t.global_step == saved,
            "phase 24 (d): params after the rollback differ from the "
            "checkpoint's")
    del t
    torch.cuda.empty_cache()
    return m


def phase_durability(counts, scale_shape=(4, 1024), ckpt_shape=(4, 1024),
                     drill_shape=(2, 512)) -> dict:
    """Phase 24: loss scaling, a checkpoint round trip of the full train
    state, a preemption drill across two processes, and a divergence
    rollback, each bitwise against its uninterrupted run."""
    log("[24] durability drills: GPT-345M loss scaling and checkpoints, "
        "preemption and rollback at 2 layers")
    t0 = time.perf_counter()
    m = {"loss_scaling": drill_loss_scaling(counts, *scale_shape),
         "checkpoint": drill_checkpoint(counts, *ckpt_shape),
         "preemption": drill_preemption(counts, batch=drill_shape[0],
                                        seq=drill_shape[1]),
         "rollback": drill_rollback(counts, batch=drill_shape[0],
                                    seq=drill_shape[1])}
    m["s"] = time.perf_counter() - t0
    log(f"  {m['s']:.1f} s")
    return m


# device kernel name -> what it is, first match wins; a key of several
# parts matches when every part is in the name. K-DEC, K-DEC8, K-MQ and
# K-MQ8 all launch the paged split kernel (and its merge): one kind. The SEG instantiations
# end in "true>" (fp32 `flash_dq_kernel<64, true>`, bf16
# `flash_dq_kernel_sm90<64, true>`); K-BSHD, K-BDQ and K-BDKV launch the
# K-PACK, K-DQ and K-DKV instantiations.
KERNEL_KINDS = ((("paged_split_kernel",), "paged"),
                (("paged_merge_kernel",), "paged"),
                (("flash_fwd_kernel", "true>"), "K-SEG"),
                (("flash_dq_kernel", "true>"), "K-SDQ"),
                (("flash_dkv_kernel", "true>"), "K-SDKV"),
                (("flash_fwd_kernel",), "K-PACK"),
                (("flash_dq_kernel",), "K-DQ"),
                (("flash_dkv_kernel",), "K-DKV"), (("nvjet",), "matmul"),
                (("gemm",), "matmul"), (("reduce_kernel",), "reduction"),
                (("elementwise",), "elementwise"), (("Memcpy",), "copy"),
                (("Memset",), "copy"), (("copy",), "copy"))


def kernel_entry(line: str) -> str:
    """A ptxas "Compiling entry function" line as the kernel's name and
    its template arguments when they are all ints and bools
    (``flash_fwd_kernel_sm90<64, true>``), else as its mangled name."""
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"I((?:L[ib]-?\d+E)+)E", mangled)
    # the name is the length-prefixed identifier that ends where the
    # template arguments begin
    name = m and next((mangled[i:m.start()] for i in range(m.start())
                       for k in (1, 2, 3) if i >= k
                       and mangled[i - k:i].isdigit()
                       and i + int(mangled[i - k:i]) == m.start()), None)
    if not name:
        return "entry " + mangled[:100]
    args = [{"b0": "false", "b1": "true"}.get(a, a[1:])
            for a in re.findall(r"L([ib]-?\d+)E", m.group(1))]
    return f"entry {name}<{', '.join(args)}>"


def kernel_kind(name: str) -> str:
    """What a device kernel is, from its demangled or mangled name."""
    if name.startswith("_Z"):
        name = kernel_entry(name)
    return next((kind for keys, kind in KERNEL_KINDS
                 if all(k in name for k in keys)), "other")


def profile_steps(step, steps) -> dict:
    """torch.profiler over ``steps`` calls of ``step`` after two warm-up
    calls: wall per step, device busy share, and device time by kernel
    and by kind."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
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
    return m


def phase_train_profile(steps=3, packed=False) -> dict:
    """Opt-in: torch.profiler over ``steps`` bf16 training steps at
    phase 8's (or, packed, phase 11's) shape: wall per step, device busy
    share, and device time by kernel."""
    log(f"[{13 if packed else 9}] profile: {steps} "
        f"{'packed ' if packed else ''}training steps, bf16, 8 x 1024")
    trainer, dev_batch, _ = train_setup(packed=packed)
    m = profile_steps(lambda: trainer.step_presharded(*dev_batch), steps)
    del trainer
    torch.cuda.empty_cache()
    return m


def phase_nn_profile(steps=3, shape=(4, 1024)) -> dict:
    """Opt-in: torch.profiler over ``steps`` of phase 12's bf16 nn-API
    steps (``GPTForCausalLM``, criterion, ``torch.optim.AdamW``)."""
    log(f"[18] profile: {steps} nn-API training steps, bf16, "
        f"{shape[0]} x {shape[1]}")
    model, opt, step = nn_setup(np.random.RandomState(12), shape)
    m = profile_steps(step, steps)
    del model, opt
    torch.cuda.empty_cache()
    return m


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,7,8,10,11,12,14,15,16,19,20,21,22,"
                    "23,24",
                    help="comma-separated; 6, 9, 13, 17 and 18 "
                    "(profiles) are opt-in")
    ap.add_argument("--drill-worker", metavar="SPEC",
                    help="run one generation of phase 24's preemption drill "
                    "(JSON spec; used by phase 24 itself)")
    args = ap.parse_args()
    if args.drill_worker:
        return drill_worker(args.drill_worker)
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
        if "Compiling entry function" in line:
            log("  " + kernel_entry(line))
        elif "Used" in line or "spill" in line or line.startswith("=="):
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
    if 14 in phases:
        e2e["spec_accuracy"] = phase_spec_accuracy(counts)
    if phases & {15, 16, 17}:
        model = build_model(DEV, torch.bfloat16)
        if 15 in phases:
            e2e["spec_load"] = phase_spec_load(model, counts)
        if 16 in phases:
            e2e["int8_load"] = phase_int8_load(model, counts)
        if 17 in phases:
            e2e["spec_profile"] = phase_profile(
                model, spec=SpecDecodeConfig(k=4))
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
    if 18 in phases:
        e2e["nn_profile"] = phase_nn_profile()
    if 19 in phases:
        e2e["llama_accuracy"] = phase_llama_accuracy(counts)
    if 20 in phases:
        e2e["llama_load"] = phase_llama_load(counts)
    if 21 in phases:
        e2e["llama_train_accuracy"] = phase_llama_train_accuracy(counts)
    if 22 in phases:
        e2e["llama_train"] = phase_train(
            counts, peaks, batch=4, seq=2048, mcfg=llama_config(num_layers=8),
            tag="phase22", label="LLaMA-7B width, 8 of 32 layers")
    if 23 in phases:
        e2e["remat"] = phase_remat(counts, peaks)
    if 24 in phases:
        e2e["durability"] = phase_durability(counts)
    # the main path: serving (phases 4, 5), training (7, 8), packed
    # training (10, 11), nn-API training (12), speculative (15) and int8
    # (16) serving, the LLaMA phases (19-22), the remat policies (23) and
    # the durability drills (24), each phase's runs counted
    main_phases = (4, 5, 7, 8, 10, 11, 12, 15, 16, 19, 20, 21, 22, 23, 24)

    def launched(which):
        return {name: sum(c.get(name, 0) for key, c in counts.items()
                          if int(key[5:].split("_")[0]) in which)
                for name in K.KERNELS}

    main_path, llama_path = launched(main_phases), launched((19, 20, 21, 22))
    if set(main_phases) <= phases:
        missing = [n for n, c in main_path.items() if c == 0]
        require(not missing, f"main path never launched {missing}")
    summary = []
    for name in K.KERNELS:
        r = kern.get(name, {})
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": main_path[name],
            "launches_llama": llama_path[name],
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "device_ms": r.get("device_ms"), "cold_ms": r.get("cold_ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"), "shape": r.get("shape"),
            **{k: r[k] for k in ("also", "llama") if k in r},
            "pass": name in kern})
    log(json.dumps({"e2e": e2e, "launches_by_phase": counts}))
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
