#!/usr/bin/env python3
"""Drive the paddle_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases 0,1,2  # device, build, kernel checks
    python3 chip_smoke.py --phases 0,1,2,14,15,16 # speculative and int8
    python3 chip_smoke.py --phases 0,1,2,19,20,21,22  # the LLaMA family
    python3 chip_smoke.py --phases 0,1,23,24  # remat policies, durability
    python3 chip_smoke.py --phases 0,1,25  # run telemetry, ops endpoint
    python3 chip_smoke.py --phases 0,1,26  # loadgen, pool plans, the fleet
    python3 chip_smoke.py --phases 0,1,27  # multi-rank training (4 ranks)
    python3 chip_smoke.py --phases 0,1,28  # pipeline parallelism (4 ranks)
    python3 chip_smoke.py --phases 0,1,2,29  # BERT, varlen attention
    python3 chip_smoke.py --phases 0,1,30  # launched ranks, durability
    python3 chip_smoke.py --phases 0,1,2,32  # dropout, masks, Transformer

Phases (any failure raises and exits non-zero; nothing is skipped):

0. device: require CUDA, print the card's name and power limit;
1. build: compile ``paddle_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card (operands drawn there, from torch generators seeded by
   numpy), at the widths of the paths that launch it, timed with
   CUDA events (median of >= 10 runs after warm-up) beside its plain
   version, the one PyTorch library call that computes the same function
   (where one exists), its device time under the profiler (which leaves
   out the card's waits on the host) and its bound (bytes over HBM
   bandwidth or FLOPs over peak, whichever is larger, at the published
   peak of the part); the paged rows also with L2 flushed between
   launches (``cold_ms``); then, untimed, the forward and backward
   kernels in bf16 at the edges of their tiles (``check_fwd_edges``,
   ``check_bwd_edges``) and the paged kernels in bf16 and fp32 at their
   chunks' edges over poisoned page tables (``check_paged_edges``),
   K-PACK, K-DQ and K-DKV at the shapes of phases 27 and 28's ring blocks
   (``ring_block_shapes``: full attention L x 2L and 2L x L among
   them, in the sub-phases' dtypes), K-SEG,
   K-SDQ and K-SDKV at the shapes of phase 27's packed rows over a mesh
   (``mesh_seg_shapes``); timed rows at the shapes the LLaMA phases launch (``LLAMA_ROWS``, d
   128, 32 heads); and, for phase 29's full attention, K-SEG, K-SDQ and
   K-SDKV with key-side ids at their tiles' edges (``check_keyside_edges``:
   Sq != Sk, ids on one side only, rows that see no key) and timed at
   ``BERT_ROWS`` (BERT-large's padded 16 x 512, the varlen row's 2048
   queries over 3072 keys), K-BSHD, K-BDQ and K-BDKV non-causal at
   BERT-base's 128 x 128 and BERT-large's 16 x 512; and the flash
   kernels' DROP and BIAS variants (attention dropout, an additive mask):
   K-BSHD, K-BDQ and K-BDKV with a causal (S, S) -inf mask, a (B, 1, 1,
   S) -1e9 padding mask, a random (B, H, Sq, Sk) bias, dropout 0.1, and
   a mask with dropout, dropout under the kernels' causal flag, a
   transposed (Sq, Sk) bias and a (Sq, 1) one, K-SEG,
   K-SDQ and K-SDKV with dropout, in fp32 and
   bf16 at ``FEATURE_EDGES`` (S 1 to 1000, Sq != Sk, ``unbind`` views, d
   128; ``check_feature_edges``) against the plain versions, which rebuild
   the same Philox bits, each dropout row's keep fraction within 4 sigma
   of 0.9, the same output on the same key and another on the next; timed
   at ``FEATURE_ROWS`` (Transformer-base's 32 x 256, GPT-345M's causal 4
   x 1024, BERT-large's padded 16 x 512) beside SDPA with the same mask
   and dropout; beside the checks, in a process of its own, each
   kernel's SASS (``cuobjdump -sass``) against
   ``paddle_tpu_torch/csrc/sass_reference.json``, the build before the
   DROP path's redesign: the line says how many kernels with neither DROP
   nor BIAS it reproduces (printed, not gated); an earlier line gives the
   registers and spill of the bf16 DROP and BIAS kernels (ptxas);
3. serving accuracy, fp32: GPT-345M's width at ``ACC_LAYERS`` (2) of
   its layers (a depth cut for the run's time; random weights, seed 0)
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
7. training accuracy, fp32: GPT-345M's width at ``ACC_LAYERS`` (2) of
   its 24 layers (params from the port's ``gpt_init``, generator seed
   0) on a 2 x 256 batch; the grads of
   ``gpt_loss`` on the card against the same grads on the CPU, every
   leaf within 1e-4 of its largest CPU grad, then 3 trainer steps on
   each side: losses within 1e-4, grad norms within 1e-4 relative;
8. training, bf16: ``HybridParallelTrainer`` on a fixed 8 x 1024 batch,
   remat and the guard on: 1 warm-up step, then 10 timed
   ``step_presharded`` calls with one synchronisation at the end; step
   ms, tokens/s, MFU, peak memory; losses finite and falling, and per
   step 48 K-PACK (forward + remat recompute), 24 K-DQ and 24 K-DKV;
9. (opt-in) profile of 3 training steps at phase 8's shape;
10. packed training accuracy, fp32: phase 7 (also at 2 layers) with
    ``TrainerConfig(packed_sequences=True)`` on 2 x 256 rows packed by
    ``io.packing.pack_documents`` (each >= 3 documents and a pad tail),
    ``gpt_loss`` with segment ids and positions;
11. packed training, bf16: phase 8 with ``packed_sequences=True`` on 8 x
    1024 rows packed from documents of 32..1024 tokens (numpy seed 0);
    step ms, tokens/s, real (non-pad) tokens/s, packing efficiency, MFU,
    peak memory; losses finite, and per step 48 K-SEG, 24 K-SDQ, 24
    K-SDKV and no K-PACK, K-DQ or K-DKV;
12. nn-API training: ``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` ->
    ``loss.backward()``; fp32 at 2 x 256 and ``ACC_LAYERS`` layers (a
    depth cut for the run's time), every parameter's grad on the card
    within 1e-4
    of its largest CPU grad (``qkv_proj`` included: its
    grad flows only through K-BSHD's backward); then bf16
    ``torch.optim.AdamW`` steps at 4 x 1024: losses finite, and per step
    24 K-BSHD, 24 K-BDQ and 24 K-BDKV;
13. (opt-in) profile of 3 packed training steps at phase 11's shape;
14. speculative and int8 serving accuracy, fp32, GPT-345M's width at
    ``ACC_LAYERS`` (2) of its layers (phase 3's depth cut): (a) 3
    repetitious requests (prompts of 100-300 tokens, 16 new tokens) through the
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
19. LLaMA serving accuracy, fp32: ``llama_7b()`` width, 1 layer, MHA
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
21. LLaMA training accuracy, fp32: ``llama_7b()`` width, 1 layer,
    GQA-8, 1 x 128: ``llama_loss`` grads and 1 trainer step card vs CPU
    (phase 7's gates), one trainer step's loss and grads under
    ``remat="names:attn_out_kernel,attn_lse,ffn_in"`` card vs CPU at the
    same gates with K-PACK launched once a layer, then
    ``LlamaForCausalLM`` + mean next-token CE + ``backward()`` card vs
    CPU (phase 12's gate; ``k_proj``/``v_proj`` grads only through
    K-BDKV);
22. LLaMA training, bf16: ``HybridParallelTrainer`` at ``llama_7b()``
    width, 4 of 32 layers, on a fixed 4 x 2048 batch, as phase 8: losses
    finite and falling, per step 8 K-PACK, 4 K-DQ and 4 K-DKV;
23. remat policies, GPT-345M: fp32 at 2 x 256 and 2 layers, for remat
    False,
    ``"full"``, ``"dots"`` and ``"names:attn_out_kernel,attn_lse"``, the
    trainer's loss and grads on the card against the CPU's under the same
    policy (phase 7's gates) and against the card's ``remat=False`` grads
    (<= 1e-6 of each leaf's largest); then ``bench.py``'s configuration
    at 12 of its 24 layers (``CUT_LAYERS``; bf16, lr 1e-4, warmup 10,
    total 1000, 56 x 1024) under True,
    ``"dots"``, ``names:`` and ``names:`` with ``ffn_in`` (the fc_in
    product saved), 1 warm-up and 3 timed steps each: step ms, tokens/s,
    MFU, peak memory, launches per step (K-PACK 12 under both ``names:``
    policies, 24 under True and ``"dots"``);
24. durability drills: (a) GPT-345M's width at 4 of 24 layers
    (``DRILL_LAYERS``), bf16 with ``loss_scaling=True``,
    ``scale_incr_every=2`` and a NaN at step 3: the scale follows its
    schedule and the losses equal, bitwise, a clean run that skips that
    batch, and the grads autograd returns under the scale are the plain
    grads times it (<= 1e-6 of each leaf's largest); (b) a sync and an
    async checkpoint of that model's full train state (bytes, save,
    snapshot, commit and load ms), and a fresh
    trainer that loads it gives the next 3 losses bitwise; (c) a worker
    process (2 layers at GPT-345M width, async saves every 2 steps) is
    preempted by ``PADDLE_FI_PREEMPT_AT_STEP=3``, exits 118 with a
    just-in-time checkpoint that verifies, and its relaunch resumes at
    step 3 and ends with the params of an uninterrupted 6-step run,
    bitwise, the two processes running beside (a), (b) and (d); (d) two
    NaN steps in a row under ``max_consecutive_skips=2`` raise
    ``NumericalDivergenceError`` rolled back to the last checkpoint,
    whose params the trainer then holds;
25. run telemetry, with the JSONL sink in a temp dir: (a) phase 8's
    trainer at 12 of 24 layers (``CUT_LAYERS``) with
    ``http_port=0``, 12 steps (the second measured by
    ``memory_plan(compute_executable=True)``): the accounted tokens/s of
    steps 4-12 within 3% of a synchronised wall of the same steps, 12
    JSONL step records, ``flops_source == "analytic_6NT"``, MFU
    (accounting) / MFU (``bench.py``'s count) = 6N / (6N + 12·L·H·S) to
    1e-6, ``/metrics`` (scraped from a thread) with the trainer's
    ``step_time_ms``, ``tokens_per_sec`` and ``mfu``, ``/healthz`` 200
    with the role and step, the memory plan's state bytes equal to the
    live tensors', ``peak_bytes_in_use`` = ``max_memory_allocated()``,
    K-PACK 48, K-DQ 24, K-DKV 24 a step; then the telemetry overhead
    ratio (OFF vs ON with the sink, interleaved, best of 3 x 8 steps,
    printed); (b) phase 4's trace with a ``ServingTracer``, an
    ``SLOTracker`` and ``start_http(0)``, scraped from a thread, with a
    1 s ``/debug/profile`` capture opened once the trace decodes: the
    request and token counters, the tracer's TTFT p50 = ``nearest_rank``
    of the requests' own, the capture holds the K-DEC launches of every
    decode tick inside its window, ``/healthz`` 200, then 503 ``wedged`` with the
    tick loop held past ``stall_threshold_s`` and 200 with ``?live``; the
    median per-tick host split and the trace overhead ratio (tracer and
    sink ON vs OFF on its first 16 requests, best of 2, printed); (c) an
    async checkpoint save and load of phase 24 (c)'s state: the
    checkpoint counters, histograms and in-flight gauge as the JAX
    package records them;
26. the rest of serving, GPT-345M: (a) phase 4's trace (bf16) through
    ``loadgen.run_continuous`` (a scheduler with a tracer) and
    ``run_static_baseline``: every request finishes, the report's tokens
    equal the scheduler's, the continuous run launches K-SEG and K-DEC
    once a layer per prefill and tick, the baseline K-BSHD once a layer
    per batch; both reports beside the tracer's TTFT and ITL; (b)
    ``plan_kv_pool`` for GPT-345M and LLaMA-7B at bf16 and int8 against
    the card's capacity (the JAX function's page counts at 80 GiB), each
    planned pool allocated alone with ``pool_bytes() == kv_bytes``, and
    ``mem_get_info`` around it; (c) ``copy_pages`` between caches of
    GPT-345M's pool shape, bf16 and int8, filled with random bytes, with
    and without ``limit``: bitwise, scales included, no other page or
    drop page touched, and a CPU cache refused; (d) a prefill-role and a
    decode-role replica (fp32 pools of 1,024 pages) under
    ``ReplicaRouter`` and ``DisaggCoordinator``, 8 requests of
    ``synthetic_trace``: every stream equals one fused replica's except
    at a near-tie (top-2 gap under 1e-3), both pools end with nothing in
    use or leased, the prefill replica launches K-SEG and no K-DEC and
    the decode replica K-DEC; then int8 pools (K-DEC8 on the decode
    replica; streams reported), then ``PADDLE_FI_HANDOFF_PARTIAL`` on one
    request, which re-prefills on the decode replica and keeps its
    stream; (e) two fused replicas on a virtual clock, ``a`` killed
    mid-decode (``PADDLE_FI_ROUTER_KILL_REPLICA``) and ``b`` wedged for
    0.5 s (``PADDLE_FI_ROUTER_WEDGE_REPLICA``): every request finishes,
    no delivered token is rewritten, fp32 streams equal the fused
    replica's by (d)'s rule, and after ``restart()`` the card's allocated
    bytes are back within one pool's bytes of their value before the
    kill; then two replicas on tick threads of their own serve 4 of the
    requests to the same streams; (f) two tenants on one replica (``multi_tenant_trace``): the
    floor-protected ``gold`` is never preempted while ``batch`` is,
    ``batch`` is shed with its bucket's refill time as the hint and
    admitted once the clock has moved by it, ``/healthz`` lists both
    tenants, ``/slo?tenant=gold`` answers the keyed view;
27. multi-rank training: 4 ranks (``chip_smoke.py --rank-worker SPEC``
    processes) share this card over gloo, which stages their sends and
    receives through pinned host buffers; first each rank checks the
    world's collectives on CUDA tensors; then (a) GPT-345M's width at 1
    of 24 layers, ``mp=2, sep=2``, 2 x 1024, the zigzag
    ring (L = 256);
    (b) that width at 2 layers, ``dp=2, sharding=2``, ZeRO 3, 4 x 1024; (c)
    LLaMA-7B's width at 1 of 32 layers, ``sep=2,
    sharding=2``, ZeRO 3, 2 x 2048: 2 fp32 steps each, the losses and each step's grad norm
    (1e-4 relative) and the gathered params (1e-4 of each leaf's
    largest) held to a single-rank trainer on the card from the same
    weights and batch (whose launches stay out of the main path's
    counts) and running beside the world; (d) (a) in bf16
    for 5 steps: the loss falls, step ms printed (4 ranks on one card,
    not a multi-card rate). Every rank's K-PACK, K-DQ and K-DKV launches
    equal ``ring_launches`` (derived from the rings' loops, printed
    first), the zigzag ring runs its L x 2L and 2L x L full blocks, and
    every rank's live state bytes equal ``plan_state_memory``'s;
    (e) GPT-345M's width at 2 layers, ``dp=2, mp=2``,
    ``packed_sequences=True``, 4 x 1024 rows packed by ``io.packing`` from
    documents of 32-1024 tokens (each dp half holding a different number
    of real labels), K-SEG, K-SDQ and K-SDKV over each rank's 8 heads;
    (f) (a) with ``ring_attention=False`` (contiguous shards, the naive
    ring), also held to (a)'s zigzag ring losses at 1e-5; (g) (c) with
    ``ring_attention=False``, held to (c)'s losses at 1e-5; each 2 fp32
    steps at (a)'s gates; (h) (e) in bf16 for 5 steps: the loss falls,
    step ms and real tokens/s (4 ranks on one card). Each rank's
    launches equal ``world_launches`` at its rank of ``"sep"`` ((e), (h)
    ``mesh_launches``; (f), (g) the naive ring's 1 + r blocks a layer on
    rank r of ``"sep"``).

28. pipeline parallelism: phase 27's world of 4 ranks on the card, over
    the ``"pipe"`` axis: (a) GPT-345M's width at 4 of 24 layers,
    ``pp=4``,
    1F1B, M=4, remat, 4 x 1024; (b) ``pp=2, mp=2``, GPipe, M=2, 2 x
    1024; (c) ``pp=2, vpp=2, dp=2``, interleaved 1F1B, M=4, remat off, 8 x
    1024; (d) LLaMA-7B's width at 2 of 32 layers, ``pp=2, sep=2``, 1F1B,
    M=2, 2 x 2048 (the zigzag ring in each stage): 2 fp32 steps each, the
    losses (1e-6 relative), each step's grad norm (1e-4) and the gathered
    params (1e-4 of each leaf's largest) held to a single-rank trainer
    on the card; (e) GPT-345M at full depth, ``pp=4``, 1F1B, M=8, remat
    off, 8 x 1024 bf16, 4 steps: step ms, tokens/s and every rank's peak
    memory (4 ranks on one card, not a pipeline's speed on four cards),
    the ideal bubble ``(pp-1)/(M+pp-1)``, and the same configuration
    under GPipe for 2 steps, whose stage-0 peak must be higher. Every
    rank's launches equal ``pipe_launches``, its most microbatches in
    flight ``min(pp - s, M)`` on stage s under 1F1B and M under GPipe,
    and its live state bytes the plan.
29. BERT and varlen attention (full attention: K-SEG, K-SDQ and K-SDKV
    with key-side ids, K-BSHD, K-BDQ and K-BDKV non-causal): (a)
    ``BertForPretraining`` at BERT-large's width, 2 of 24 layers, fp32,
    2 x 512, card vs CPU on the same weights, once with row 0 padded to
    200 tokens (the K-SEG kernels) and once unpadded (the K-BSHD ones):
    MLM and NSP logits 2e-3, loss 1e-4, every grad 1e-4 of its leaf's
    largest; (b) ``bench_all.py``'s BERT-base step (full depth, 128 x
    128, fp32, MLM loss, momentum SGD lr 0.01, hidden and attention
    dropout 0.1): step ms, tokens/s, MFU by the bench's count
    against the fp32 peak; (c) BERT-large at full depth, bf16 AdamW,
    16 x 512 padded to phase 2's key lengths: step ms, tokens/s, real
    tokens/s, peak memory; (d) ``nn.functional.flash_attn_unpadded``,
    8 sequences, 2048 queries over 3072 keys, fp32 output and grads
    against the plain version, and the causal call with distinct
    ``cu_seqlens`` raising on the card. Each launch is full attention,
    and each sub-phase's launches are the kernels' counts derived from
    its layers and steps.

30. launched, durable multi-rank training: ``python -m
    paddle_tpu_torch.distributed.launch`` starts 4 ranks (``chip_smoke.py
    --launch-worker SPEC``) on this card over gloo, GPT-345M's width at 2
    of 24 layers, fp32, ``mp=2, sharding=2`` ZeRO 3, 2 x 1024, async
    checkpoints every 2 steps, 7 steps; an uninterrupted run (beside
    (c)) is the reference of one run under ``--elastic --max_restarts
    1`` (ab): (b) a preemption notice at step 3 (every rank's
    just-in-time checkpoint, exit 118, the immediate relaunch at no
    budget, zero lost steps), then (a) a SIGKILL of rank 2 after step 6,
    its async save in flight (the watcher's crash and the relaunch on the
    budget's one restart, generation 2 from the newest step every rank
    completed, at least step 4), bitwise in losses and final params;
    (c) 2 ranks at ``dp=2`` with the
    consistency check every 2 steps and a desync planted on rank 0 at
    step 3 exit 119 at step 4, classified ``desync``; (d) (ab)'s
    checkpoint resumes on one rank, its next two losses (the second
    after an update that reads the loaded moments) within 1e-5 of the
    reference's. Checkpoint bytes per rank, snapshot, commit and load ms,
    the seconds from the preemption and from the kill to the relaunched
    generation's first step, and the reference's ``guard_probe`` (step
    ms with the preemption guard off and on) are printed; every rank's
    launches equal ``ring_launches``.
31. (opt-in) phase 30's world alone on the card, twice: 2 steps, then
    ``guard_probe`` (step ms with the preemption guard off and on, with
    no other run sharing the card).
32. the transformer layers, attention dropout and masks inside the
    kernels: (a) ``nn.Transformer`` at Transformer-base width (512, 8
    heads), 1 + 1 layers, fp32, batch 2, src 96 / tgt 80, source padding
    masks and the causal target mask made on the card, attention dropout
    0.1 from one key and hidden dropout 0, card vs CPU: output 2e-3, loss
    1e-4, every grad 1e-4 of its leaf's largest; (b) Transformer-base at
    full depth (6 + 6), bf16, dropout 0.1 everywhere, 32 sentence pairs
    padded to 256 / 256 (real lengths 32-256, seed 32) over a shared
    vocabulary of 37,000 (the harness's embedding and tied projection),
    AdamW, 20 steps: the loss falls, step ms, tokens/s, real tokens/s,
    peak memory, K-BSHD, K-BDQ and K-BDKV 18 a step each; (c) GPT-345M
    through the nn API at its default dropouts (0.1 / 0.1), 3 bf16 steps
    at 4 x 1024, and BERT's padding row with no real token card vs CPU
    (logits 2e-3, loss 1e-4, grads 1e-4: the BIAS variants' backward).

Each main-path phase (3-5, 7, 8, 10-12, 14-16, 19-30, 32) sets the
kernels' launch counts to 0 just before it and reads them just after
(phases 27, 28 and 30 in each rank, the counts summed over the ranks;
phases 29 and 32 also the DROP and BIAS variants'). The line before the
last is the kernels' JSON summary, the variants beside the kernels; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

if __name__ == "__main__":
    # Where the interpreter finds no bytecode for torch's modules (a
    # read-only site-packages), every process compiles them from source:
    # a rank or worker process of this script spent ~5 s on it at import
    # and ~13 s more in its first training step, whose
    # ``torch.utils.checkpoint`` imports ``torch._dynamo``. Their bytecode
    # goes to the checkout's build directory instead, for this process and
    # the ones it starts.
    PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "pycache")
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import numpy as np
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.io.packing import pack_documents, packing_efficiency
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_345m)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
from paddle_tpu_torch.observability import hw
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.parallel import hybrid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      NgramDrafter, Request, ServingConfig,
                                      ServingEngine, SpecDecodeConfig,
                                      repetitious_trace)
from paddle_tpu_torch.utils.tree import flatten, tree_map

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
    "K-SEG": ("paddle_tpu_torch/csrc/flash_fwd.cuh",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:467"),
    "K-BSHD": ("paddle_tpu_torch/csrc/flash_fwd.cuh",
               "paddle_tpu/ops/pallas/flash_attention.py:63"),
    "K-PACK": ("paddle_tpu_torch/csrc/flash_fwd.cuh",
               "paddle_tpu/ops/pallas/flash_attention_packed.py:49"),
    "K-DQ": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
             "paddle_tpu/ops/pallas/flash_attention_packed.py:106"),
    "K-DKV": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:159"),
    "K-SDQ": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
              "paddle_tpu/ops/pallas/flash_attention_packed.py:523"),
    "K-SDKV": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
               "paddle_tpu/ops/pallas/flash_attention_packed.py:575"),
    "K-BDQ": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
              "paddle_tpu/ops/pallas/flash_attention.py:134"),
    "K-BDKV": ("paddle_tpu_torch/csrc/flash_bwd.cuh",
               "paddle_tpu/ops/pallas/flash_attention.py:188"),
}


# when each phase's header line was logged (phase -> perf_counter)
PHASE_STARTS: dict = {}


T_START = time.perf_counter()


def log(*a):
    head = re.match(r"\[(\d+)\] ", str(a[0])) if a else None
    if head:
        PHASE_STARTS[int(head.group(1))] = now = time.perf_counter()
        a = (f"{a[0]} (at {now - T_START:.1f} s)",) + a[1:]
        # the header on stderr too: a run stopped at its time limit shows
        # there which phase it was in
        print(f"chip_smoke: phase {head.group(1)} at {now - T_START:.1f} s",
              file=sys.stderr, flush=True)
    print(*a, flush=True)


def lap(what, t0) -> None:
    """Log a step of a phase with its seconds since ``t0``."""
    log(f"  -- {what}: {time.perf_counter() - t0:.1f} s")


def phase_seconds(end) -> dict:
    """Each logged phase's seconds, to the next phase's header (the
    last to ``end``)."""
    marks = sorted(PHASE_STARTS.items(), key=lambda kv: kv[1])
    return {p: round((marks[i + 1][1] if i + 1 < len(marks) else end) - t,
                     1) for i, (p, t) in enumerate(marks)}


def require(cond, what) -> None:
    """A check of this run that raises (an ``assert`` vanishes under
    ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def peaks_for(name: str) -> dict:
    """The part's published peaks from the port's one table
    (``observability.hw``), the trainer's MFU denominator too."""
    peaks = hw.peaks_for(name)
    if peaks is None:
        raise RuntimeError(f"no published peaks for {name!r}")
    return peaks


def time_ms(fn, iters=20, warmup=3) -> float:
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


def cold_ms(fn, iters=10, warmup=3) -> float:
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


# the port's kernels as the profiler names them: each wrapper call
# launches one of these (K-DEC, K-DEC8, K-MQ and K-MQ8 the split kernel,
# and after it the merge)
PORT_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                "paged_split_kernel")


def device_ms(fn, floor_ms, iters=10, warmup=3, tries=5) -> float:
    """Device time of one ``fn`` call under torch.profiler: the kernels
    it launched, summed, per call. Beside ``time_ms``'s CUDA-event time,
    which also counts the gaps where the card waits on the host, it
    shows whether a call is bound by its kernel or by its host work.
    The profiler drops launches: in some traces all of them, in some
    rows a few of every trace (1 of 20, 2 or 7 of 21). So the time is per
    launch of ``PORT_KERNELS`` it caught (one per call), and a trace
    counts only when it caught at least half of its calls and a time of
    at least ``floor_ms`` (the call's bound); after ``tries`` traces
    without one the phase fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {ev.key: ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA}
        caught = sum(n for k, n in seen.items()
                     if any(p in k for p in PORT_KERNELS))
        ms = sum(device_ms_by_kernel(prof).values()) / max(caught, 1)
        if 2 * caught >= iters and ms >= floor_ms:
            return ms
        log(f"  device_ms: the profiler caught {caught} of {iters} "
            f"launches, {ms:.4f} ms against a bound of {floor_ms:.4f} ms; "
            f"profiling again (device events: {seen})")
    require(False, f"device_ms: no profile of {iters} calls caught half "
            f"their launches at or above the bound in {tries} traces")


def bound_ms(nbytes: float, flops: float, dtype, peaks) -> tuple:
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks["bf16" if dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2: kernels against their plain versions --------------------------

def device_gen(rng, dev=None) -> torch.Generator:
    """A torch generator on ``dev`` (default the card) seeded by one draw
    of the numpy ``rng``: phase 2's operands are drawn on the device, as
    numpy's ``randn`` of a K/V pool took seconds of the host."""
    dev = torch.device(dev or DEV)
    return torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))


def normal(rng, *shape, dtype=torch.float32, dev=None) -> torch.Tensor:
    """Standard normal fp32 draws of ``shape`` on ``dev`` (default the
    card) from :func:`device_gen`, cast to ``dtype``."""
    dev = torch.device(dev or DEV)
    return torch.randn(shape, generator=device_gen(rng, dev),
                       device=dev).to(dtype)


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
    q = normal(rng, *qshape, dtype=dtype)
    if int8:
        kp, vp = (torch.randint(-127, 128, (n_pages, ps, nh_kv * d),
                                generator=device_gen(rng), device=dev,
                                dtype=torch.int8) for _ in range(2))
        # dequantized values within ~[-3.8, 3.8], as N(0, 1) K/V would be
        sc = torch.from_numpy(rng.uniform(0.01, 0.03, (n_pages, 2, nh_kv))
                              .astype(np.float32)).to(dev)
    else:
        kp, vp = (normal(rng, n_pages, ps, nh_kv * d, dtype=dtype)
                  for _ in range(2))
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
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        res["ms"] = time_ms(lambda: kern(q, kp, vp, pt_t, sl_t, scales=sc))
        res["device_ms"] = device_ms(lambda: kern(q, kp, vp, pt_t, sl_t,
                                                  scales=sc),
                                     res["bound_ms"])
        res["cold_ms"] = cold_ms(lambda: kern(q, kp, vp, pt_t, sl_t,
                                              scales=sc))
        res["plain_ms"] = time_ms(lambda: plain(q, kp, vp, pt_t, sl_t,
                                                scales=sc), iters=10)
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
    q, k, v = (normal(rng, len(seg), t, nh * d, dtype=dtype)
               for _ in range(3))
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
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        res["ms"] = time_ms(lambda: fp.flash_attention_packed_segmented(
            q, k, v, seg_t, nh))
        res["device_ms"] = device_ms(
            lambda: fp.flash_attention_packed_segmented(q, k, v, seg_t, nh),
            res["bound_ms"])
        res["plain_ms"] = time_ms(lambda: fp.segment_attention_ref(
            q, k, v, seg_t, nh), iters=10)
        qh, kh, vh = (x.view(1, t, nh, d).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        idx = torch.arange(t, device=dev)
        mask = ((seg_t[0][:, None] == seg_t[0][None, :])
                & (idx[None, :] <= idx[:, None]))[None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                                    iters=10)
        res["shape"] = (f"T={t} nh={nh} d={d} 8 segments + pad "
                        f"(pairs={pairs}) {str(dtype)[6:]}")
    return res


def check_bshd(rng, dtype, b, s, h, d, peaks, timed):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dev = DEV
    q, k, v = (normal(rng, b, s, h, d, dtype=dtype) for _ in range(3))
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
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype,
                                                    peaks)
        res["ms"] = time_ms(lambda: fa.bshd_fwd(q, k, v))
        res["device_ms"] = device_ms(lambda: fa.bshd_fwd(q, k, v),
                                     res["bound_ms"])
        res["plain_ms"] = time_ms(lambda: fa.causal_attention_ref(q, k, v),
                                  iters=10)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                    iters=10)
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
                   .view(b, s, hp).copy_(normal(rng, b, s, hp))
                   for _ in range(4))
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
        return normal(rng, *shape, dtype=dtype)

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
        r["bound_ms"], r["bound_by"] = bound_ms(*work[name], dtype, peaks)
        r["ms"] = time_ms(kern)
        r["device_ms"] = device_ms(kern, r["bound_ms"])
        r["plain_ms"] = time_ms(plain, iters=5)
        r["library_ms"] = lib_ms[name]
        r["shape"] = shape
    return out


def sdpa_ms(qh, kh, vh, doh, **kw):
    """SDPA's forward and its backward through autograd (dQ, dK and dV in
    one call), ms, on ``(B, H, S, D)`` copies."""
    qh, kh, vh = (x.detach().requires_grad_() for x in (qh, kh, vh))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), iters=10)
    oh = sdpa(qh, kh, vh, **kw)
    bwd = time_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                              retain_graph=True), iters=10)
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


def visible_pairs_keys(seg_q, seg_k) -> int:
    """Pairs of equal query- and key-side ids, summed over the rows of
    ``(B, Sq)`` and ``(B, Sk)`` arrays (full attention)."""
    total = 0
    for rq, rk in zip(seg_q, seg_k):
        ids_q, n_q = np.unique(rq, return_counts=True)
        ids_k, n_k = np.unique(rk, return_counts=True)
        _, iq, ik = np.intersect1d(ids_q, ids_k, return_indices=True)
        total += int((n_q[iq].astype(np.int64) * n_k[ik]).sum())
    return total


def visible_tokens(seg_q, seg_k) -> tuple:
    """``(queries, keys)``: the queries that see some key and the keys
    that some query sees, counted over the rows of ``(B, Sq)`` and
    ``(B, Sk)`` id arrays (full attention). The result depends on no
    other row of q, k, v, dO, lse or delta."""
    return (sum(int(np.isin(rq, rk).sum()) for rq, rk in zip(seg_q, seg_k)),
            sum(int(np.isin(rk, rq).sum()) for rq, rk in zip(seg_q, seg_k)))


def check_seg_train(rng, dtype, b, s, nh, d, peaks, timed, seg=None,
                    what=None, seg_k=None, causal=True, dropout_p=0.0,
                    key=None):
    """K-SEG, K-SDQ and K-SDKV against their plain
    versions on ``b`` rows packed from documents of 32..1024 tokens
    (numpy seed 0; pad tails), or on the given ``(b, s)`` ids, q, k, v
    column slices of one fused qkv; with ``seg_k`` ``(b, Sk)`` full
    attention (``causal`` False) over keys with ids of their own, q, k, v
    separate tensors. The backward pair takes the kernel forward's lse
    and delta; a row that sees no key must give lse ``EMPTY_LSE`` on both
    sides, and the other rows' lse are held apart from it. Bounds count
    only the visible pairs, and reads of only the rows that take part in
    one (``visible_tokens``; causal self-attention: every row), every
    output written whole and every id read; the library time is SDPA's
    backward with the equivalent boolean mask. With ``dropout_p`` (and the
    Philox ``key``) the kernels' DROP variants, held to the plain
    versions that rebuild the same bits (``drop_checks``), their rows
    named ``K-SEG+drop`` and so on."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    if seg is None:
        (_, _, seg, _), eff = packed_rows(0, b, s, 32, 1024, 50304)
        what = f"packed ({eff:.3f} real)"
    sk = s if seg_k is None else seg_k.shape[1]
    pairs = (visible_pairs_seg(seg) if seg_k is None
             else visible_pairs_keys(seg, seg_k))
    seg_t = torch.from_numpy(seg).to(DEV)
    kid = None if seg_k is None else torch.from_numpy(seg_k).to(DEV)
    kw = dict(segment_ids_k=kid, causal=causal)
    if dropout_p:
        kw.update(dropout_p=dropout_p, rng=key)
    q, k, v, do = train_inputs(rng, dtype, b, s, nh, d, sk)
    o, lse = fp.seg_fwd(q, k, v, seg_t, nh, **kw)
    delta = (do.float() * o.float()).reshape(b, s, nh, d).sum(-1)
    dq = fp.seg_dq(q, k, v, do, lse, delta, seg_t, nh, **kw)
    dk, dv = fp.seg_dkv(q, k, v, do, lse, delta, seg_t, nh, **kw)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fp.segment_attention_ref(qf, kf, vf, seg_t, nh, **kw)
    rdq = fp.segment_dq_ref(qf, kf, vf, dof, lse, delta, seg_t, nh, **kw)
    rdk, rdv = fp.segment_dkv_ref(qf, kf, vf, dof, lse, delta, seg_t, nh,
                                  **kw)
    seen = rlse > fp.EMPTY_LSE / 2
    require(bool((lse[~seen] == fp.EMPTY_LSE).all()),
            "K-SEG: a row that sees no key lacks the empty lse")
    label = (f"B={b} Sq={s} Sk={sk} nh={nh} d={d} "
             f"{'causal' if causal else 'full'} {what} "
             f"(pairs={pairs * nh}, {int((~seen).sum())} empty rows"
             f"{f', dropout {dropout_p}' if dropout_p else ''})")
    tag = "+drop" if dropout_p else ""
    out = hold((("K-SEG" + tag, ((o, ro), (lse[seen], rlse[seen]))),
                ("K-SDQ" + tag, ((dq, rdq),)),
                ("K-SDKV" + tag, ((dk, rdk), (dv, rdv)))), dtype, label)
    if dropout_p:
        drop_checks(lambda r: fp.seg_fwd(q, k, v, seg_t, nh, **{
            **kw, "rng": r})[0], o, key, dropout_p, (b, nh, s, sk), label)
    if not timed:
        return out
    nq, nk = ((b * s, b * sk) if seg_k is None
              else visible_tokens(seg, seg_k))
    tok = nh * d * torch.finfo(dtype).bits // 8   # one token of q, k, ...
    row = nh * 4                                  # ... of lse or delta
    ids = (b * s + (0 if seg_k is None else b * sk)) * 4
    work = {"K-SEG": (tok * (nq + 2 * nk + b * s) + row * b * s + ids,
                      4.0 * d * nh * pairs),
            "K-SDQ": (tok * (2 * nq + 2 * nk + b * s) + row * 2 * nq + ids,
                      6.0 * d * nh * pairs),
            "K-SDKV": (tok * (2 * nq + 2 * nk + 2 * b * sk) + row * 2 * nq
                       + ids, 8.0 * d * nh * pairs)}
    runs = {
        "K-SEG": (lambda: fp.seg_fwd(q, k, v, seg_t, nh, **kw),
                  lambda: fp.segment_attention_ref(q, k, v, seg_t, nh, **kw)),
        "K-SDQ": (lambda: fp.seg_dq(q, k, v, do, lse, delta, seg_t, nh,
                                    **kw),
                  lambda: fp.segment_dq_ref(q, k, v, do, lse, delta, seg_t,
                                            nh, **kw)),
        "K-SDKV": (lambda: fp.seg_dkv(q, k, v, do, lse, delta, seg_t, nh,
                                      **kw),
                   lambda: fp.segment_dkv_ref(q, k, v, do, lse, delta,
                                              seg_t, nh, **kw)),
    }
    qh, kh, vh, doh = (x.reshape(b, x.shape[1], nh, d).transpose(1, 2)
                       .contiguous() for x in (q, k, v, do))
    mask = seg_t[:, :, None] == (seg_t if kid is None else kid)[:, None, :]
    if causal:
        idx = torch.arange(s, device=DEV)
        mask = mask & (idx[None, :] <= idx[:, None])[None]
    lib_fwd, lib_bwd = sdpa_ms(qh, kh, vh, doh, attn_mask=mask[:, None],
                               dropout_p=dropout_p)
    runs = {name + tag: run for name, run in runs.items()}
    work = {name + tag: w for name, w in work.items()}
    return time_rows(out, runs, work, {"K-SEG" + tag: lib_fwd,
                                       "K-SDQ" + tag: lib_bwd,
                                       "K-SDKV" + tag: lib_bwd}, dtype,
                     peaks, f"{label} {str(dtype)[6:]}")


def check_bshd_train(rng, dtype, b, s, h, d, peaks, timed, causal=True):
    """K-BSHD, K-BDQ and K-BDKV against their plain versions, causal or
    full, with q, k, v the ``unbind`` views of one ``(B, S, 3, H, D)``
    tensor (``GPTAttention``'s and ``BertSelfAttention``'s layout, row
    stride 3*H*D); the backward pair takes the kernel forward's lse and
    delta."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    def randn(*shape):
        return normal(rng, *shape, dtype=dtype)

    q, k, v = randn(b, s, 3, h, d).unbind(2)
    do = randn(b, s, h, d)
    kw = dict(causal=causal)
    o, lse = fa.bshd_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.bshd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.bshd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fa.causal_attention_ref(qf, kf, vf, **kw)
    rdq = fa.bshd_dq_ref(qf, kf, vf, dof, lse, delta, **kw)
    rdk, rdv = fa.bshd_dkv_ref(qf, kf, vf, dof, lse, delta, **kw)
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    label = (f"(B,S,H,D)=({b},{s},{h},{d}) "
             f"{'causal' if causal else 'full'}, unbind views")
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
        "K-BSHD": (lambda: fa.bshd_fwd(q, k, v, **kw),
                   lambda: fa.causal_attention_ref(q, k, v, **kw)),
        "K-BDQ": (lambda: fa.bshd_dq(q, k, v, do, lse, delta, **kw),
                  lambda: fa.bshd_dq_ref(q, k, v, do, lse, delta, **kw)),
        "K-BDKV": (lambda: fa.bshd_dkv(q, k, v, do, lse, delta, **kw),
                   lambda: fa.bshd_dkv_ref(q, k, v, do, lse, delta, **kw)),
    }
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd, lib_bwd = sdpa_ms(qh, kh, vh, doh, is_causal=causal)
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


# phase 2's rows at the shapes BERT and varlen attention launch (phase
# 29): full attention with key-side ids at BERT-large's padded batch
# (B, S, nh, d), the varlen row (sequences, total_q, total_k, nh, d), and
# the unpadded BERT-base (bench_all.py's 128 x 128) and BERT-large
# batches (B, S, H, D)
BERT_ROWS = {"padded": (16, 512, 16, 64), "varlen": (8, 2048, 3072, 16, 64),
             "bshd": ((128, 128, 12, 64), (16, 512, 16, 64))}


def bert_key_lengths(b, s, seed=29):
    """Each row's real length, uniform in [128, s] (seed 29): the padded
    batch of phase 2's K-SEG row and phase 29 (c)."""
    return np.random.RandomState(seed).randint(min(128, s), s + 1, b)


def padding_ids(lengths, s):
    """BERT's padding mask as segment ids (``BertModel``'s own
    ``padding_key_ids``): queries 0, keys 0 on the first ``lengths[i]``
    tokens of row i and -1 after them; ``(B, s)`` int32 each."""
    from paddle_tpu_torch.models.bert import padding_key_ids

    mask = np.arange(s)[None] < np.asarray(lengths)[:, None]
    return tuple(t.numpy() for t in padding_key_ids(torch.from_numpy(mask)))


def varlen_cu(nseq, total, seed):
    """``cu_seqlens`` of ``nseq`` sequences of random lengths (each >= 1)
    filling ``total`` tokens."""
    rng = np.random.RandomState(seed)
    lens = rng.multinomial(total - nseq, np.ones(nseq) / nseq) + 1
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def varlen_ids(cu, total):
    """Per-token sequence ids of ``cu`` over ``total`` tokens (pads -1),
    as ``(1, total)`` int32: ``flash_attn_unpadded``'s."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    return fp.cu_seqlens_to_segment_ids(torch.from_numpy(cu), total
                                        )[None].numpy()


def bert_rows(peaks, rows=None) -> dict:
    """The full-attention kernels at ``BERT_ROWS``, bf16 and timed, from a
    seed of their own (29, the key lengths' too): K-SEG, K-SDQ and K-SDKV
    with key-side ids at the padded shape and at the varlen shape
    (``Sq != Sk``), K-BSHD, K-BDQ and K-BDKV non-causal at the unpadded
    shapes. ``{name: [row, ...]}``."""
    r = rows or BERT_ROWS
    rng = np.random.RandomState(29)
    bf = torch.bfloat16
    out = {}

    def add(res):
        for name, row in res.items():
            out.setdefault(name, []).append(
                {k: row[k] for k in ROW_KEYS if k in row})

    b, s, nh, d = r["padded"]
    lens = bert_key_lengths(b, s)
    seg_q, seg_k = padding_ids(lens, s)
    add(check_seg_train(rng, bf, b, s, nh, d, peaks, True, seg=seg_q,
                        seg_k=seg_k, causal=False,
                        what=f"padding, keys {lens.min()}-{lens.max()}"))
    nseq, tq, tk, nh, d = r["varlen"]
    seg_q = varlen_ids(varlen_cu(nseq, tq, 30), tq)
    seg_k = varlen_ids(varlen_cu(nseq, tk, 31), tk)
    add(check_seg_train(rng, bf, 1, tq, nh, d, peaks, True, seg=seg_q,
                        seg_k=seg_k, causal=False,
                        what=f"varlen, {nseq} sequences"))
    for b, s, h, d in r["bshd"]:
        add(check_bshd_train(rng, bf, b, s, h, d, peaks, True,
                             causal=False))
    return out


def check_keyside_edges(dtype=torch.bfloat16, heads=None) -> dict:
    """K-SEG, K-SDQ and K-SDKV with key-side ids at their tiles' edges,
    untimed, from a seed of their own: ``seg_edges``' rows as query ids
    against a shuffled draw of the same ids over 700 keys (Sq 1000 != Sk:
    ids on one side only, rows that see no key, hash collisions, int32
    extremes), then the padding mask at S 129 with keys of 1, 64 and 129
    tokens; each at d 64 and 128. Returns each kernel's worst error."""
    rng = np.random.RandomState(4)
    worst = dict.fromkeys(("K-SEG", "K-SDQ", "K-SDKV"), 0.0)

    def keep(res):
        for name, r in res.items():
            worst[name] = max(worst[name], r["max_abs_err"])

    for d in (64, 128):
        nh = heads or 1024 // d
        seg_q = seg_edges(rng, 1000)
        seg_k = np.stack([rng.permutation(row)[:700] for row in seg_q])
        seg_k[1, :50] = 123456789          # an id no query carries
        keep(check_seg_train(rng, dtype, 3, 1000, nh, d, None, False,
                             seg=seg_q, seg_k=seg_k, causal=False,
                             what="edge ids, keys drawn apart"))
        seg_q, seg_k = padding_ids([1, 64, 129], 129)
        keep(check_seg_train(rng, dtype, 3, 129, nh, d, None, False,
                             seg=seg_q, seg_k=seg_k, causal=False,
                             what="padding, keys 1, 64, 129"))
    return worst


# -- phase 2: the flash kernels' DROP and BIAS variants ---------------------

# (B, Sq, Sk, H, D) at the edges check_bwd_edges uses (S 1 to 1000, Sq !=
# Sk, d 128), q, k, v the ``unbind`` views of one (B, S, 3, H, D) tensor
# when Sq == Sk; each with every entry of FEATURES, fp32 and bf16
FEATURE_EDGES = [(2, 1, 1, 16, 64), (2, 129, 129, 16, 64),
                 (2, 1000, 1000, 16, 64), (2, 300, 700, 16, 64),
                 (2, 129, 129, 8, 128)]
# (mask kind, dropout_p, kernel causal): a causal (Sq, Sk) -inf mask
# (end-aligned), a padding mask (B, 1, 1, Sk) of -1e9, a random full (B,
# H, Sq, Sk) bias, dropout alone, both together, dropout under the
# kernels' own causal flag (GPT's no-cache training; Sq == Sk rows only),
# a random (Sq, Sk) bias read through a transposed view (the ``.mT`` of an
# (Sk, Sq) tensor: key stride Sq, query stride 1) and a random (Sq, 1) one
# broadcast over the keys (key stride 0). The bf16 kernels stage the first
# three by TMA where their rows are 16-byte multiples and by cp.async
# otherwise (S 129), the last two always by cp.async (``bias_route``).
FEATURES = (("causal", 0.0, False), ("padding", 0.0, False),
            ("full", 0.0, False), (None, 0.1, False), ("causal", 0.1, False),
            ("padding", 0.1, False), (None, 0.1, True),
            ("transposed", 0.0, False), ("column", 0.0, False))
# the timed rows: K-BSHD, K-BDQ, K-BDKV at Transformer-base's phase 32 (b)
# shape (B, S, H, D), +bias with its encoder's padding mask and
# +bias+drop with its decoder's causal mask; +drop causal at GPT-345M's
# phase 32 (c) shape; K-SEG, K-SDQ, K-SDKV +drop at BERT-large's padded
# batch (B, S, nh, d) (phase 29 (c), phase 32 (c))
FEATURE_ROWS = {"bshd": (32, 256, 8, 64), "gpt": (4, 1024, 16, 64),
                "seg": (16, 512, 16, 64)}
# what each variant replaces: the JAX package runs active dropout and a
# mask densely (no TPU kernel computes either)
VARIANT_REPLACES = {
    "K-BSHD": "paddle_tpu/nn/functional/attention.py:20",
    "K-BDQ": "paddle_tpu/nn/functional/attention.py:20",
    "K-BDKV": "paddle_tpu/nn/functional/attention.py:20",
    "K-SEG": "paddle_tpu/ops/attention_dispatch.py:42",
    "K-SDQ": "paddle_tpu/ops/attention_dispatch.py:42",
    "K-SDKV": "paddle_tpu/ops/attention_dispatch.py:42",
}
VARIANTS = tuple(f"{n}{t}" for n in ("K-BSHD", "K-BDQ", "K-BDKV")
                 for t in ("+bias", "+drop", "+bias+drop")) + tuple(
    f"{n}+drop" for n in ("K-SEG", "K-SDQ", "K-SDKV"))


# the SASS of the kernels without DROP, recorded from the build of the
# sources before the DROP path's redesign (``sass_digests``): phase 2
# prints how many of them this build reproduces
SASS_REFERENCE = (Path(__file__).resolve().parent / "paddle_tpu_torch" /
                  "csrc" / "sass_reference.json")


def sass_digests(lib) -> dict:
    """``{kernel: sha256 of its SASS}`` of a built library: ``cuobjdump
    -sass``, each function's instructions alone (no addresses or
    encodings; nvcc's per-file anonymous-namespace tag cut out), keyed
    by ``kernel_entry``'s name. A kernel that several sources instantiate
    hashes its copies together."""
    text = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    name = None
    for line in text.splitlines():
        if "Function : " in line:
            name = kernel_entry(line.split("Function : ")[1].strip())
            name = name.removeprefix("entry ")
            funcs.setdefault(name, []).append([])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.+?)\s*;", line)
        if name and m:
            funcs[name][-1].append(re.sub(r"_GLOBAL__N__\w*", "ANON",
                                          m.group(1)))
    return {n: hashlib.sha256(json.dumps(sorted(
        "\n".join(c) for c in copies)).encode()).hexdigest()
        for n, copies in funcs.items()}


def nvcc_version() -> str:
    out = subprocess.run([_build.cuda_tool(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def sass_start() -> subprocess.Popen:
    """``sass_digests`` of this build in a process of its own, beside
    phase 2's kernel checks (cuobjdump and the parse take ~13 s)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sass-digests",
         _build.last_build["path"]], stdout=subprocess.PIPE, text=True)


def sass_finish(proc) -> dict:
    out, _ = proc.communicate(timeout=600)
    require(proc.returncode == 0, f"--sass-digests exited {proc.returncode}")
    return json.loads(out)["kernels"]


def featured(name) -> bool:
    """Whether a kernel name (``kernel_entry``'s form) is a flash
    template's DROP or BIAS instantiation (third or fourth argument
    true)."""
    args = name.partition("<")[2].rstrip(">").split(", ")
    return name.startswith("flash_") and len(args) == 4 and (
        "true" in args[2:])


def check_sass(got) -> dict:
    """This build's SASS digests ``got`` against ``SASS_REFERENCE``: the
    kernels with neither DROP nor BIAS (the flash templates' third and
    fourth arguments false, and the paged kernels) that equal the
    reference, and the DROP or BIAS instantiations that differ from it,
    changed on purpose. Printed, not gated: a later change to a kernel
    changes its SASS on purpose."""
    ref = json.loads(SASS_REFERENCE.read_text())
    plain = sorted(n for n in got if not featured(n))
    same = [n for n in plain if ref["kernels"].get(n) == got[n]]
    feats = sorted(n for n in got if featured(n))
    moved = [n for n in feats if ref["kernels"].get(n) != got[n]]
    res = {"reference": ref["source"], "nvcc": nvcc_version(),
           "reference_nvcc": ref["nvcc"], "plain": len(plain),
           "plain_equal": len(same), "feature": len(feats),
           "feature_changed": len(moved),
           "plain_differ": sorted(set(plain) - set(same)),
           "feature_same": sorted(set(feats) - set(moved))}
    differ = ("" if len(same) == len(plain) else
              f", differ: {res['plain_differ']}")
    log(f"  SASS against {ref['source']} ({ref['nvcc']}; this build "
        f"{res['nvcc']}): {len(same)} of {len(plain)} kernels with "
        f"neither DROP nor BIAS equal{differ}; {len(moved)} of "
        f"{len(feats)} DROP or BIAS instantiations changed on purpose "
        f"(unchanged: {res['feature_same']})")
    return res


def ptxas_usage(text) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from a
    build's ``-Xptxas -v`` log, keyed by ``kernel_entry``'s name; a kernel
    that several sources instantiate keeps its largest figures."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_entry(line).removeprefix("entry ")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        r = re.search(r"Used (\d+) registers", line)
        if name and (m or r):
            cur = out.setdefault(name, {"registers": 0, "spill_stores": 0,
                                        "spill_loads": 0})
            if m:
                cur["spill_stores"] = max(cur["spill_stores"], int(m[1]))
                cur["spill_loads"] = max(cur["spill_loads"], int(m[2]))
            if r:
                cur["registers"] = max(cur["registers"], int(r[1]))
    return out


def log_feature_registers(text, label="") -> dict:
    """Logs the registers and spill of the flash templates' bf16 DROP and
    BIAS instantiations (the Hopper bodies, ``*_sm90``) from a build's
    ptxas log, on one line after ``label``; returns them."""
    usage = {n: u for n, u in ptxas_usage(text).items()
             if featured(n) and "_sm90<" in n}
    log(f"  {label}registers / spill stores of the bf16 DROP and BIAS "
        "kernels: " + "; ".join(f"{n} {u['registers']} / {u['spill_stores']}"
                                for n, u in sorted(usage.items())))
    return usage


def variant_tag(kind, dropout_p) -> str:
    return ("+bias" if kind else "") + ("+drop" if dropout_p else "")


def feature_bias(rng, kind, b, h, sq, sk, dev=None):
    """A mask of ``kind`` (``FEATURES``) from ``rng``, fp32 on ``dev``."""
    dev = dev or DEV
    if kind == "causal":         # generate_square_subsequent_mask's
        i = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        j = torch.arange(sk, device=dev)[None]
        return torch.zeros(sq, sk, device=dev).masked_fill(j > i,
                                                           float("-inf"))
    if kind == "padding":        # BERT's (m - 1) * 1e9, keys 1 to Sk long
        lens = rng.randint(1, sk + 1, b)
        m = (np.arange(sk)[None] < lens[:, None]).astype(np.float32)
        return torch.from_numpy((m - 1.0) * 1e9).to(dev)[:, None, None, :]
    if kind == "transposed":     # (Sq, Sk) at strides (1, Sq)
        return normal(rng, sk, sq, dev=dev).mT
    if kind == "column":         # (Sq, 1): one value a query
        return normal(rng, sq, 1, dev=dev)
    return normal(rng, b, h, sq, sk, dev=dev)


def drop_key(rng) -> tuple:
    """A Philox ``(seed, offset)`` drawn from ``rng``."""
    return tuple(int(x) for x in rng.randint(0, 2 ** 62, 2))


def drop_checks(fwd, o, key, dropout_p, shape, label) -> None:
    """A DROP variant's keep bits: their fraction within 4 sigma of
    ``1 - dropout_p`` (the bits the plain version rebuilt and the kernel
    just matched), and the kernel's output ``fwd(key)`` the same on the
    same key and another on the next key (``(seed, offset + 1)``)."""
    from paddle_tpu_torch.ops.kernels import philox

    n = int(np.prod(shape))
    frac = float(philox.keep_mask(key, dropout_p, shape, o.device)
                 .float().mean())
    sigma = (dropout_p * (1.0 - dropout_p) / n) ** 0.5
    same = bool(torch.equal(fwd(key), o))
    other = not bool(torch.equal(fwd((key[0], key[1] + 1)), o))
    ok = abs(frac - (1.0 - dropout_p)) <= 4 * sigma and same and (
        other or n < 256)
    log(f"  keep bits {label}: fraction {frac:.5f} (1 - p = "
        f"{1 - dropout_p}, 4 sigma {4 * sigma:.5f}), same key same output "
        f"{same}, next key another {other} {'ok' if ok else 'FAIL'}")
    require(ok, f"dropout keep bits fail their checks at {label}")


def check_bshd_features(rng, dtype, b, sq, sk, h, d, kind, dropout_p,
                        peaks, timed, causal=False):
    """K-BSHD, K-BDQ and K-BDKV with BIAS (a ``kind`` mask) and DROP
    (``dropout_p``, a key from ``rng``), under the kernels' ``causal``
    flag or not, against their plain versions, which add the same mask
    and rebuild the same Philox bits; the backward pair takes the kernel
    forward's lse and delta. Bounds count the pairs the mask and the flag
    leave visible (-1e9 and -inf entries excluded) and the mask's own
    bytes; the library time is SDPA with the same ``attn_mask``,
    ``is_causal`` and ``dropout_p``, forward and backward."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    def randn(*shape):
        return normal(rng, *shape, dtype=dtype)

    if sq == sk:
        q, k, v = randn(b, sq, 3, h, d).unbind(2)
    else:
        q, k, v = randn(b, sq, h, d), randn(b, sk, h, d), randn(b, sk, h, d)
    do = randn(b, sq, h, d)
    bias = feature_bias(rng, kind, b, h, sq, sk) if kind else None
    key = drop_key(rng) if dropout_p else None
    kw = dict(causal=causal, bias=bias, dropout_p=dropout_p, rng=key)
    o, lse = fa.bshd_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.bshd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.bshd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ro, rlse = fa.causal_attention_ref(qf, kf, vf, **kw)
    rdq = fa.bshd_dq_ref(qf, kf, vf, dof, lse, delta, **kw)
    rdk, rdv = fa.bshd_dkv_ref(qf, kf, vf, dof, lse, delta, **kw)
    tag = variant_tag(kind, dropout_p)
    label = (f"(B,Sq,Sk,H,D)=({b},{sq},{sk},{h},{d}) mask {kind}, "
             f"dropout {dropout_p}{', causal' if causal else ''}")
    out = hold(((f"K-BSHD{tag}", ((o, ro), (lse, rlse))),
                (f"K-BDQ{tag}", ((dq, rdq),)),
                (f"K-BDKV{tag}", ((dk, rdk), (dv, rdv)))), dtype, label)
    if dropout_p:
        drop_checks(lambda r: fa.bshd_fwd(q, k, v, **{**kw, "rng": r})[0],
                    o, key, dropout_p, (b, h, sq, sk), label)
    if not timed:
        return out
    elem = torch.finfo(dtype).bits // 8
    seen = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        seen = seen.tril()
    pairs = (b * h * int(seen.sum()) if bias is None else
             int(((fp.bias_view(bias, b, h, sq, sk) > -1e8) & seen).sum()))
    aq, ak = b * sq * h * d * elem, b * sk * h * d * elem
    row = b * sq * h * 4
    mb = 0 if bias is None else bias.numel() * 4
    work = {f"K-BSHD{tag}": (2 * aq + 2 * ak + row + mb, 4.0 * d * pairs),
            f"K-BDQ{tag}": (3 * aq + 2 * ak + 2 * row + mb, 6.0 * d * pairs),
            f"K-BDKV{tag}": (2 * aq + 4 * ak + 2 * row + mb,
                             8.0 * d * pairs)}
    runs = {
        f"K-BSHD{tag}": (lambda: fa.bshd_fwd(q, k, v, **kw),
                         lambda: fa.causal_attention_ref(q, k, v, **kw)),
        f"K-BDQ{tag}": (lambda: fa.bshd_dq(q, k, v, do, lse, delta, **kw),
                        lambda: fa.bshd_dq_ref(q, k, v, do, lse, delta,
                                               **kw)),
        f"K-BDKV{tag}": (lambda: fa.bshd_dkv(q, k, v, do, lse, delta, **kw),
                         lambda: fa.bshd_dkv_ref(q, k, v, do, lse, delta,
                                                 **kw)),
    }
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd, lib_bwd = sdpa_ms(
        qh, kh, vh, doh, dropout_p=dropout_p, is_causal=causal,
        attn_mask=None if bias is None else bias.to(dtype))
    return time_rows(out, runs, work, {f"K-BSHD{tag}": lib_fwd,
                                       f"K-BDQ{tag}": lib_bwd,
                                       f"K-BDKV{tag}": lib_bwd}, dtype,
                     peaks, f"{label} (pairs={pairs}) {str(dtype)[6:]}")


def check_feature_edges(heads=None) -> dict:
    """The DROP and BIAS variants at their edges, untimed, from a seed of
    their own: K-BSHD, K-BDQ and K-BDKV at ``FEATURE_EDGES`` with every
    entry of ``FEATURES`` (the kernels' causal flag at Sq == Sk); K-SEG, K-SDQ and K-SDKV with dropout 0.1 on
    ``seg_edges``' rows (causal) and on the padding mask's key-side ids
    (S 129, keys of 1, 64 and 129 tokens); each in fp32 and bf16.
    ``heads`` sets every head count (the CPU rehearsal). Returns each
    variant's worst error."""
    rng = np.random.RandomState(16)
    worst = dict.fromkeys(VARIANTS, 0.0)

    def keep(res):
        for name, r in res.items():
            worst[name] = max(worst[name], r["max_abs_err"])

    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, sk, h, d in FEATURE_EDGES:
            for kind, p, causal in FEATURES:
                if causal and sq != sk:
                    continue
                keep(check_bshd_features(rng, dtype, b, sq, sk, heads or h,
                                         d, kind, p, None, False,
                                         causal=causal))
        for d in (64, 128):
            nh = heads or 1024 // d
            keep(check_seg_train(rng, dtype, 3, 1000, nh, d, None, False,
                                 seg=seg_edges(rng, 1000),
                                 what="edge ids", dropout_p=0.1,
                                 key=drop_key(rng)))
            seg_q, seg_k = padding_ids([1, 64, 129], 129)
            keep(check_seg_train(rng, dtype, 3, 129, nh, d, None, False,
                                 seg=seg_q, seg_k=seg_k, causal=False,
                                 what="padding, keys 1, 64, 129",
                                 dropout_p=0.1, key=drop_key(rng)))
    return worst


def feature_rows(peaks, rows=None) -> dict:
    """The variants timed at ``FEATURE_ROWS``, bf16, from a seed of their
    own: ``{variant: row}``."""
    r = rows or FEATURE_ROWS
    rng = np.random.RandomState(32)
    bf = torch.bfloat16
    out = {}
    for shape, kind, p, causal in (("bshd", "padding", 0.0, False),
                                   ("gpt", None, 0.1, True),
                                   ("bshd", "causal", 0.1, False)):
        b, s, h, d = r[shape]
        out.update(check_bshd_features(rng, bf, b, s, s, h, d, kind, p,
                                       peaks, True, causal=causal))
    b, s, nh, d = r["seg"]
    lens = bert_key_lengths(b, s)
    seg_q, seg_k = padding_ids(lens, s)
    out.update(check_seg_train(rng, bf, b, s, nh, d, peaks, True, seg=seg_q,
                               seg_k=seg_k, causal=False,
                               what=f"padding, keys {lens.min()}-"
                               f"{lens.max()}", dropout_p=0.1,
                               key=drop_key(rng)))
    return out


# one run of ``feature_rows`` in a tree (its own chip_smoke.py and
# kernels), the rows' times as one JSON line
AB_RUN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
rows = cs.feature_rows(cs.peaks_for(torch.cuda.get_device_name(0)))
print("ROWS " + json.dumps({k: {f: r.get(f) for f in (
    "device_ms", "ms", "bound_ms", "library_ms", "max_abs_err")}
    for k, r in rows.items()}))
"""


def ab_feature_rows(trees, order) -> dict:
    """An A/B of the DROP and BIAS variants across source trees on one
    card: ``trees`` maps a name to a directory holding a ``chip_smoke.py``
    and its ``paddle_tpu_torch`` (the parent from ``git archive``, edited
    copies), each building its kernels into its own ``build/``, all at
    once first; then ``feature_rows`` runs in each tree in ``order``, one
    process a run, in turns. Prints each run's device and event ms and
    each tree's ptxas registers / spill stores of its bf16 DROP and BIAS
    kernels; returns ``{variant: {tree: [device ms of each run]}}``."""
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    build = ("import sys; sys.path.insert(0, '.'); from paddle_tpu_torch."
             "ops.kernels import _build; _build.load_library(); "
             "print(_build.last_build['path'])")
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 env=env, stdout=subprocess.PIPE, text=True)
             for n, d in trees.items()}
    for n, proc in procs.items():
        lib = proc.communicate()[0].strip().splitlines()
        require(proc.returncode == 0 and lib, f"ab: {n} did not build")
        log_feature_registers(Path(lib[-1]).with_suffix(".log").read_text(),
                              f"ab [{n}] ")
    got = {}
    for n in order:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=trees[n],
                             env=env, capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines() if x.startswith("ROWS ")]
        require(out.returncode == 0 and line,
                f"ab: {n} failed\n{out.stdout[-2000:]}{out.stderr[-2000:]}")
        rows = json.loads(line[0][5:])
        log(f"  ab [{n}] device / event ms: " + json.dumps(
            {k: [r["device_ms"], r["ms"]] for k, r in rows.items()}))
        for k, r in rows.items():
            got.setdefault(k, {}).setdefault(n, []).append(r["device_ms"])
    for k, by in sorted(got.items()):
        log(f"  ab {k}: " + "; ".join(
            f"{n} {float(np.median(v)):.4f} ("
            + ", ".join(f"{x:.4f}" for x in v) + ")"
            for n, v in by.items()))
    return got


def phase_kernels(peaks) -> dict:
    log("[2] kernels against their plain versions")
    log_feature_registers(_build.last_build.get("log", ""))
    sass = sass_start()
    try:
        out = kernel_checks(peaks)
        t2 = time.perf_counter()
        check_sass(sass_finish(sass))
        lap("SASS (after the checks)", t2)
    finally:
        if sass.poll() is None:
            sass.kill()
            sass.wait()
    return out


def kernel_checks(peaks) -> dict:
    """Phase 2's checks and timed rows: ``{kernel or variant: row}``."""
    rng = np.random.RandomState(0)
    bf, f32 = torch.bfloat16, torch.float32
    out = {}
    t2 = time.perf_counter()
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
    lap("paged kernels", t2)
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
    lap("K-SEG, K-BSHD", t2)
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
    lap("K-PACK, K-DQ, K-DKV", t2)
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
    lap("K-SDQ, K-SDKV, K-BDQ, K-BDKV", t2)
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
    lap("forward edges", t2)
    for name, err in check_bwd_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    lap("backward edges", t2)
    # the rings' blocks at phases 27 and 28's shapes (full attention with
    # Sq != Sk among them), from a seed of their own
    ring_rng = np.random.RandomState(27)
    for dt, b, sq, sk, nh, d, causal in ring_block_shapes():
        for name, r in check_train(ring_rng, getattr(torch, dt), b, sq, nh,
                                   d, None, timed=False, causal=causal,
                                   sk=sk).items():
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                           r["max_abs_err"])
    lap("ring blocks", t2)
    # phase 27's packed rows over a mesh: a rank's rows and heads
    for dt, b, s, nh, d in mesh_seg_shapes():
        for name, r in check_seg_train(ring_rng, getattr(torch, dt), b, s,
                                       nh, d, None, timed=False).items():
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                           r["max_abs_err"])
    lap("mesh packed rows", t2)
    for name, err in check_paged_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    lap("paged edges", t2)
    for name, err in check_keyside_edges().items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    lap("key-side edges", t2)
    for name, rows in bert_rows(peaks).items():
        out[name]["bert"] = rows
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       *(r["max_abs_err"] for r in rows))
    lap("BERT rows", t2)
    for name, rows in llama_rows(peaks).items():
        out[name]["llama"] = rows
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       *(r["max_abs_err"] for r in rows))
    lap("LLaMA rows", t2)
    # the DROP and BIAS variants: at their edges, then timed
    edges = check_feature_edges()
    lap("feature edges", t2)
    for name, row in feature_rows(peaks).items():
        row["max_abs_err"] = max(row["max_abs_err"], edges[name])
        out[name] = row
    lap("feature rows", t2)
    for name, row in out.items():
        for r in (row, row.get("also"), *row.get("llama", ()),
                  *row.get("bert", ())):
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


def build_model(device, dtype, layers=None):
    """GPT-345M (at ``layers`` of its depth where given), random weights
    from seed 0."""
    return GPTForCausalLM(_acc_model(layers), device=device, dtype=dtype,
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
    log(f"[3] serving accuracy, fp32: card vs teacher-forced CPU forward, "
        f"{ACC_LAYERS} layers")
    model = build_model(DEV, torch.float32, ACC_LAYERS)
    cpu = build_model("cpu", torch.float32, ACC_LAYERS)
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


def serve_load(model, cfg, reqs, spec, what, before_run=None,
               **sched_kw) -> tuple:
    """Serve ``reqs`` through a fresh scheduler (``spec``: its speculative
    config; ``sched_kw``: its other arguments) over a warmed-up engine of
    ``cfg``; every request must finish with finite logits, no page may
    leak, and each kernel must launch once per layer per tick of its
    kind. ``before_run(sched)`` runs just before the requests are
    submitted. Returns the metrics and the scheduler (its engine at
    ``.engine``)."""
    eng = ServingEngine(model, cfg)
    warm = ContinuousBatchingScheduler(eng, spec_decode=spec, tracer=None)
    warm.submit(Request(rid=-1, prompt=reqs[0].prompt, max_new_tokens=8))
    warm.run()
    sched = ContinuousBatchingScheduler(eng, spec_decode=spec, **sched_kw)
    if before_run is not None:
        before_run(sched)
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
    log(f"[14] speculative and int8 serving accuracy, fp32, {ACC_LAYERS} "
        "layers")
    serving = serving or dict(page_size=16, max_model_len=1024,
                              max_batch=8, max_prefill_tokens=2048)
    model = build_model(DEV, torch.float32, ACC_LAYERS)
    cpu = build_model("cpu", torch.float32, ACC_LAYERS)
    layers = model.cfg.num_layers
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
    require(counts["phase14"]["K-MQ"] == len(sched.verify_ticks) * layers,
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
    require(counts["phase14_int8"]["K-DEC8"] == decode_steps * layers
            and counts["phase14_int8"]["K-MQ8"] == layers,
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


def worst_grad(g_card, g_cpu, rounding=0.0):
    """The leaf whose card grad is furthest from the CPU's, as a share of
    the largest CPU grad of that leaf: ``(ratio, name)``. A leaf whose
    largest CPU grad is at most ``rounding`` times the largest of any
    leaf holds rounding only (its true grad is 0) and is measured against
    that global largest instead."""
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_leaf = 0.0, None
    for name, want in g_cpu.items():
        scale = float(want.abs().max())
        if scale <= rounding * top:
            scale = top
        ratio = max_err(g_card[name], want) / scale
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


# the depth of phases 3, 7, 10, 12, 14 (fp32) and 23 (a) in the default
# run: the layers are identical, and at GPT-345M's 24 each phase's CPU
# side took ~55 s
ACC_LAYERS = 2


def _acc_model(layers):
    """GPT-345M's config, at ``layers`` of its depth where given."""
    mcfg = model_config()
    return dataclasses.replace(mcfg, num_layers=layers) if layers else mcfg


def phase_train_accuracy(counts, batch=2, seq=256, layers=None) -> dict:
    mcfg = _acc_model(layers)
    log(f"[7] training accuracy, fp32: GPT-345M width, {mcfg.num_layers} "
        f"layers, card vs CPU, {batch} x {seq}")
    tcfg = hybrid.TrainerConfig(compute_dtype=torch.float32,
                                learning_rate=1e-3, warmup_steps=2,
                                total_steps=10)
    tokens, labels = train_batch(np.random.RandomState(0), batch, seq,
                                 model_config().vocab_size)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = card_vs_cpu(tcfg, (tokens, labels), "unpacked", mcfg=mcfg)
    counts["phase7"] = K.launch_counts()
    log(f"  launches {counts['phase7']}; {time.perf_counter() - t0:.1f} s")
    for name in ("K-PACK", "K-DQ", "K-DKV"):
        require(counts["phase7"][name] > 0, f"phase 7 never launched {name}")
    return m


def phase_packed_accuracy(counts, batch=2, seq=256, doc_lengths=(20, 100),
                          seed=0, layers=None) -> dict:
    mcfg = _acc_model(layers)
    log(f"[10] packed training accuracy, fp32: GPT-345M width, "
        f"{mcfg.num_layers} layers, card vs CPU, {batch} x {seq} packed")
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
    m = card_vs_cpu(tcfg, rows, "packed", mcfg=mcfg)
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
    efficiency)``. Earlier phases' trainers that wait in reference
    cycles are collected first: phase 22 needs ~66 GB of the card, and
    ~8 GB of phase 21's state left uncollected ran it out of memory."""
    gc.collect()
    torch.cuda.empty_cache()
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
    card = build_model(DEV, torch.float32, ACC_LAYERS).train()
    cpu = build_model("cpu", torch.float32, ACC_LAYERS).train()
    cpu.load_state_dict(card.state_dict())
    ids, labels = train_batch(rng, *acc_shape, vocab)
    K.reset_launch_counts()
    acc = nn_grads_vs_cpu(card, cpu, ids, labels, ("qkv_proj",), "nn API")
    depth = card.cfg.num_layers
    del card, cpu
    torch.cuda.empty_cache()
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        require(acc["launches"][name] == depth, f"nn-API backward launched "
                f"{name} {acc['launches'][name]} times, not {depth}")

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
                               seq=128, steps=3) -> dict:
    """LLaMA training accuracy, fp32, at ``llama_7b()`` width, ``layers``
    layers, GQA: (a) ``llama_loss`` grads and ``steps`` trainer steps, card vs
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
               for _ in range(steps + 1)]
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


def bench_setup(remat, shape=(56, 1024), layers=None):
    """A bf16 trainer at ``bench.py``'s config (at ``layers`` of its
    depth where given) under ``remat`` and its batch on the card: random
    tokens and labels of ``shape`` (seed 0)."""
    mcfg = _acc_model(layers)
    trainer = hybrid.HybridParallelTrainer(
        mcfg, hybrid.TrainerConfig(remat=remat, **BENCH_TRAINER))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, mcfg.vocab_size, shape)
    labs = rng.randint(0, mcfg.vocab_size, shape)
    return trainer, trainer.shard_batch(toks, labs)


def phase_remat(counts, peaks, acc=(2, 256), speed=(56, 1024),
                steps=3, acc_layers=None, speed_layers=None) -> dict:
    """Phase 23: the remat policies at GPT-345M. (a) fp32 at ``acc`` (and
    ``acc_layers`` of its depth where given): per
    policy the trainer's loss and grads on the card against the CPU's
    under the same policy (phase 7's gates) and against the card's own
    ``remat=False`` grads (<= 1e-6 of each leaf's largest); (b) bf16 at
    ``bench.py``'s config and ``speed`` batch: per policy 1 warm-up and
    ``steps`` timed steps, K-PACK 24 a step under the ``names:`` policies
    and 48 under True and ``"dots"``."""
    mcfg = _acc_model(acc_layers)
    layers = mcfg.num_layers
    log(f"[23] remat policies: GPT-345M, fp32 {acc[0]} x {acc[1]} at "
        f"{layers} layers card vs CPU, then bf16 {speed[0]} x {speed[1]} "
        "(bench.py's config)")
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
    mcfg = _acc_model(speed_layers)     # (b) at bench.py's config
    layers = mcfg.num_layers
    for remat in SPEED_POLICIES:
        tag = f"phase23_{policy_tag(remat)}"
        trainer, (t_dev, l_dev) = bench_setup(remat, speed, speed_layers)
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


# the depth of phases 23 (b) and 25 (a): 12 of GPT-345M's 24 layers, and
# of phase 24 (a) and (b): 4 (their checks are bitwise whatever the
# depth, and a checkpoint of 12 layers took 20 s to write and read), so
# the default run, phase 30's launched runs included, stays inside its
# time limit on a card whose host is slow
CUT_LAYERS = 12
DRILL_LAYERS = 4


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


def drill_loss_scaling(counts, batch=4, seq=1024, steps=6, nan_step=3,
                       layers=None):
    """(a) ``loss_scaling=True``, ``scale_incr_every=2``, a NaN at
    ``nan_step``: the scale follows ``scale_schedule``, and every loss
    equals, bitwise, a clean run's that skips that batch; the grads
    autograd returns under the scale are the plain grads times it."""
    mcfg = _acc_model(layers or DRILL_LAYERS)
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


def drill_checkpoint(counts, batch=4, seq=1024, before=2, after=3,
                     layers=None):
    """(b) A sync save after ``before`` steps, one more step, an async
    save (two checkpoints of the full train state on disk), then a fresh
    trainer loads the newest: its next ``after`` losses equal the
    uninterrupted run's bitwise."""
    mcfg = _acc_model(layers or DRILL_LAYERS)
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
    # on the CPU a reduction's bits depend on how many threads split it,
    # and the worker processes and this one each size their thread teams
    # at run time: one thread everywhere keeps the runs bitwise
    threads = torch.get_num_threads()
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    try:
        t = hybrid.HybridParallelTrainer(mcfg, drill_config(),
                                         device=spec["device"])
        loader = DrillLoader(2400, spec["batch"], spec["seq"],
                             mcfg.vocab_size)
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
    finally:
        torch.set_num_threads(threads)
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


class PreemptionDrill:
    """(c) A worker process trains ``layers`` layers at GPT-345M width
    with async saves every ``save_every`` steps and
    ``PADDLE_FI_PREEMPT_AT_STEP``: it exits 118 with a just-in-time
    checkpoint that verifies; the relaunch resumes there, and its params
    after ``steps`` steps equal an uninterrupted run's bitwise. The
    workers run beside the phase's other drills: the first starts here,
    :meth:`relaunch` waits for it and starts the second, :meth:`finish`
    runs the uninterrupted run in this process, waits for the second and
    checks; :meth:`close` ends a worker still running."""

    def __init__(self, layers=2, batch=2, seq=512, steps=6, preempt_at=3,
                 save_every=2):
        self.work = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
        cfg = dataclasses.replace(model_config(), num_layers=layers)
        self.preempt_at = preempt_at
        self.spec = {"model": dataclasses.asdict(cfg), "device": DEV.type,
                     "batch": batch, "seq": seq, "steps": steps,
                     "save_every": save_every,
                     "root": os.path.join(self.work, "ckpt"),
                     "out": os.path.join(self.work, "params.npz")}
        self.env = dict(os.environ,
                        PADDLE_FI_PREEMPT_AT_STEP=str(preempt_at),
                        PADDLE_FI_DIR=os.path.join(self.work, "fi"))
        self.runs, self.proc = [], None
        self._start()

    def _start(self):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--drill-worker",
             json.dumps(self.spec)], env=self.env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def _wait(self):
        try:
            out, err = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
        self.runs.append({"rc": self.proc.returncode,
                          "s": time.perf_counter() - self.t0,
                          "stdout": out.strip()[-300:],
                          "stderr": err.strip()[-600:]})
        self.proc = None

    def relaunch(self):
        self._wait()
        self._start()

    def close(self):
        if self.proc is not None:
            self.proc.kill()
            self.proc.communicate()
            self.proc = None
        shutil.rmtree(self.work, ignore_errors=True)

    def finish(self, counts) -> dict:
        spec, runs, preempt_at = self.spec, self.runs, self.preempt_at
        K.reset_launch_counts()
        ref, _ = drill_train(spec)
        counts["phase24_preempt"] = K.launch_counts()
        want = {"/".join(path): p.cpu().numpy()
                for path, p in flatten(ref.params)}
        del ref
        torch.cuda.empty_cache()
        self._wait()
        jit = os.path.join(spec["root"], f"step-{preempt_at}")
        jit_ok = ckpt.verify_checkpoint(jit)
        got = dict(np.load(spec["out"])) if runs[1]["rc"] == 0 else {}
        self.close()
        resumed = json.loads(runs[1]["stdout"].splitlines()[-1]) \
            if runs[1]["rc"] == 0 else None
        m = {"runs": runs, "jit_checkpoint": jit_ok, "relaunch": resumed,
             "params_bitwise": got.keys() == want.keys() and all(
                 np.array_equal(got[k], want[k]) for k in want)}
        log("  (c) preemption: " + json.dumps(m))
        require(runs[0]["rc"] == hybrid.PREEMPTED_EXIT_CODE,
                f"phase 24 (c): the preempted worker exited "
                f"{runs[0]['rc']}, not {hybrid.PREEMPTED_EXIT_CODE}: "
                f"{runs[0]['stderr']}")
        require(jit_ok[0], f"phase 24 (c): just-in-time checkpoint "
                f"{jit_ok}")
        require(runs[1]["rc"] == 0 and resumed["resumed_at"] == preempt_at,
                f"phase 24 (c): the relaunch did not resume at "
                f"{preempt_at}: {runs[1]}")
        require(m["params_bitwise"], "phase 24 (c): params after the "
                "relaunch differ from the uninterrupted run's")
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
    state, a preemption drill across two processes (beside the others),
    and a divergence rollback, each bitwise against its uninterrupted
    run."""
    log(f"[24] durability drills: GPT-345M width, loss scaling and "
        f"checkpoints at {DRILL_LAYERS} layers, preemption and rollback "
        f"at 2")
    t0 = time.perf_counter()
    drill = PreemptionDrill(batch=drill_shape[0], seq=drill_shape[1])
    try:
        m = {"loss_scaling": drill_loss_scaling(counts, *scale_shape),
             "checkpoint": drill_checkpoint(counts, *ckpt_shape)}
        drill.relaunch()
        m["rollback"] = drill_rollback(counts, batch=drill_shape[0],
                                       seq=drill_shape[1])
        m["preemption"] = drill.finish(counts)
    finally:
        drill.close()
    m["s"] = time.perf_counter() - t0
    log(f"  {m['s']:.1f} s")
    return m


# -- phase 25: run telemetry and the ops endpoint ------------------------------

def http_get(url, timeout=60):
    """``(status, body)`` of one GET; an HTTP error's status too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class Scraper:
    """Scrapes ``routes`` of an ops endpoint from its own thread, every
    ``every`` seconds and once more when stopped: ``codes[route]`` holds
    every status seen, ``last[route]`` the newest ``(status, body)``."""

    def __init__(self, url, routes, every=0.25):
        import threading

        self.url, self.routes, self.every = url, routes, every
        self.codes = {r: [] for r in routes}
        self.last = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _scrape(self):
        for route in self.routes:
            self.last[route] = http_get(self.url + route)
            self.codes[route].append(self.last[route][0])

    def _run(self):
        while not self._stop.wait(self.every):
            self._scrape()
        self._scrape()

    def stop(self):
        self._stop.set()
        self._thread.join()
        return self


def jsonl_records(obs_dir):
    """Every record of the sink's streams under ``obs_dir``."""
    from paddle_tpu_torch.observability import sink

    sink.flush()
    recs = []
    for name in sorted(os.listdir(obs_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(obs_dir, name)) as f:
                recs += [json.loads(line) for line in f if line.strip()]
    return recs


def state_nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size()
               for tree in trees for _, x in flatten(tree))


def telemetry_train(counts, peaks, obs_dir, steps=12, batch=8, seq=1024,
                    trials=3, trial_steps=8, warmup=3) -> dict:
    """(a) Phase 8's trainer with telemetry, the sink and ``http_port=0``:
    ``steps`` steps (the second measured by ``memory_plan(
    compute_executable=True)``), the accounting against a synchronised
    wall of steps 4..N, the JSONL step records, both MFUs, the scraped
    endpoint, the memory plan against the live tensors; then the
    telemetry overhead ratio, the JAX package's protocol at this shape
    (OFF vs ON with the sink live and a heartbeat file, ``warmup`` steps
    each, then interleaved, best of ``trials`` x ``trial_steps``
    steps)."""
    from paddle_tpu_torch import observability as obs

    mcfg = _acc_model(CUT_LAYERS)
    tcfg = dict(learning_rate=3e-4, warmup_steps=2, total_steps=100)
    trainer = hybrid.HybridParallelTrainer(
        mcfg, hybrid.TrainerConfig(http_port=0, **tcfg))
    tokens, labels = train_batch(np.random.RandomState(0), batch, seq,
                                 mcfg.vocab_size)
    dev_batch = trainer.shard_batch(tokens, labels)
    scraper = Scraper(trainer.http.url, ("/metrics", "/healthz"))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    host_ms, t_wall = [], None
    for i in range(steps):
        if i == 1:
            trainer.memory_plan(compute_executable=True)  # measures step 2
        if i == 3:
            torch.cuda.synchronize()
            t_wall = time.perf_counter()
        t0 = time.perf_counter()
        trainer.step_presharded(*dev_batch)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    counts["phase25_train"] = K.launch_counts()
    summ = trainer.telemetry_summary()
    peak = torch.cuda.max_memory_allocated()
    scraper.stop()
    trainer.http.stop()
    label = trainer.telemetry.trainer
    recs = [r for r in jsonl_records(obs_dir)
            if r.get("kind") == "step" and r.get("trainer") == label]
    tok = batch * seq
    timed = recs[3:]
    acc_tok_s = len(timed) * tok / (sum(r["step_time_ms"]
                                        for r in timed) / 1e3)
    wall_tok_s = (steps - 3) * tok / wall_s
    host_tok_s = (steps - 3) * tok / (sum(host_ms[3:]) / 1e3)
    n = trainer.num_params()
    flops_tok = 6 * n + 12 * mcfg.num_layers * mcfg.hidden_size * seq
    hist = summ["step_time_ms"]          # steps 2..N, the gauge's window
    bench_mfu = (hist["count"] * tok / (hist["sum"] / 1e3) * flops_tok
                 / peaks["bf16"])
    live = state_nbytes(trainer.params, trainer.opt)
    plan = summ["memory_plan"]
    planned = (plan["state"]["params"]["global_bytes"]
               + plan["state"]["opt_state"]["global_bytes"])
    mem = summ["device_memory"]
    metrics = scraper.last["/metrics"][1].decode()
    health_code, health = scraper.last["/healthz"]
    health = json.loads(health)
    m = {"steps": steps, "records": len(recs),
         "accounted_tokens_per_s": acc_tok_s,
         "synced_wall_tokens_per_s": wall_tok_s,
         "accounted_vs_wall": acc_tok_s / wall_tok_s - 1,
         "host_wall_tokens_per_s": host_tok_s,
         "host_wall_vs_wall": host_tok_s / wall_tok_s - 1,
         "step_time_ms": hist, "compile_ms": summ["compile_ms"],
         "flops_source": summ["flops_source"],
         "mfu_accounting": summ["mfu"], "mfu_bench": bench_mfu,
         "mfu_ratio": summ["mfu"] / bench_mfu,
         "mfu_ratio_want": 6 * n / flops_tok,
         "memory_plan_bytes": planned, "live_state_bytes": live,
         "executable_plan": plan["executable"],
         "device_memory": mem, "max_memory_allocated": peak,
         "healthz": [health_code, health.get("role"), health.get("step")],
         "scrapes": {r: len(c) for r, c in scraper.codes.items()},
         "launches": counts["phase25_train"]}
    layers = mcfg.num_layers
    want = {"K-PACK": 2 * layers, "K-DQ": layers, "K-DKV": layers}
    del trainer
    torch.cuda.empty_cache()
    m["obs_instrumentation_overhead_ratio"] = train_overhead_ratio(
        mcfg, tcfg, (tokens, labels), trials, trial_steps, warmup)
    log("  (a) training: " + json.dumps(m))
    require(len(recs) == steps, f"phase 25 (a): {len(recs)} step records")
    require(abs(m["accounted_vs_wall"]) <= 0.03,
            f"phase 25 (a): accounted tokens/s {acc_tok_s:.1f} vs the "
            f"synchronised wall's {wall_tok_s:.1f}")
    require(m["flops_source"] == "analytic_6NT", m["flops_source"])
    require(abs(m["mfu_ratio"] / m["mfu_ratio_want"] - 1) <= 1e-6,
            f"phase 25 (a): MFU ratio {m['mfu_ratio']} != 6N / (6N + "
            f"12LHS) {m['mfu_ratio_want']}")
    for name in ("step_time_ms", "tokens_per_sec", "mfu"):
        key = f'{name}{{trainer="{label}"'
        require(key in metrics, f"phase 25 (a): /metrics lacks {key}")
    require(health_code == 200 and health.get("role") == "trainer"
            and health.get("step") == steps, f"phase 25 (a): {health}")
    require(planned == live, f"phase 25 (a): memory plan {planned} B, "
            f"live state {live} B")
    for name, per_step in want.items():
        require(counts["phase25_train"][name] == per_step * steps,
                f"phase 25 (a): {name} {counts['phase25_train']}")
    if DEV.type == "cuda":
        require(mem["max"]["peak_bytes_in_use"] == peak,
                f"phase 25 (a): peak {mem} vs {peak}")
        require(plan["executable"]["source"] == "measured"
                and plan["executable"]["peak_bytes"] > 0,
                f"phase 25 (a): {plan['executable']}")
    return m


def train_overhead_ratio(mcfg, tcfg, batch, trials, steps, warmup):
    """``obs_instrumentation_overhead_ratio``: telemetry OFF vs ON with
    the sink live and a heartbeat file, each arm ``steps`` steps a trial,
    interleaved, best of ``trials``: OFF s/step over ON s/step."""
    hb = tempfile.mkdtemp(prefix="chip_smoke_hb_")
    old = os.environ.get("PADDLE_HEARTBEAT_FILE")
    os.environ["PADDLE_HEARTBEAT_FILE"] = os.path.join(hb, "hb")
    try:
        arms = {}
        for on in (True, False):
            t = hybrid.HybridParallelTrainer(
                mcfg, hybrid.TrainerConfig(telemetry=on, **tcfg))
            arms[on] = (t, t.shard_batch(*batch))

        def measure(on):
            t, b = arms[on]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                t.step_presharded(*b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps

        for _ in range(warmup):
            for on in (True, False):
                arms[on][0].step_presharded(*arms[on][1])
        best = {True: float("inf"), False: float("inf")}
        for _ in range(trials):
            for on in (False, True):
                best[on] = min(best[on], measure(on))
        del arms
        torch.cuda.empty_cache()
        return best[False] / best[True]
    finally:
        if old is None:
            os.environ.pop("PADDLE_HEARTBEAT_FILE", None)
        else:
            os.environ["PADDLE_HEARTBEAT_FILE"] = old
        shutil.rmtree(hb, ignore_errors=True)


def kernel_events(trace_path, key) -> int:
    """Device kernel events of a Chrome trace whose name holds ``key``."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel"
               and key in e.get("name", ""))


def telemetry_serve(counts, obs_dir, n_req=64, trials=2, ratio_req=16,
                    serving=None, trace=None, stall_s=3.0) -> dict:
    """(b) Phase 4's trace through a scheduler with a ``ServingTracer``,
    an ``SLOTracker`` (``DEFAULT_SLOS``) and ``start_http(0)``, scraped
    from a thread while it runs, with a 1 s ``/debug/profile`` capture
    that the first decode tick starts and waits for, so its window lies
    inside the trace (a capture asked for at the trace's start once
    opened only after the trace had ended: CUPTI's set-up alone can take
    seconds); the capture must hold the K-DEC launches of every decode
    tick inside its window. Then the counters, the tracers' TTFT, the wedged readiness, the
    per-tick host split, and the trace overhead ratio (tracer and sink
    ON vs OFF on the trace's first ``ratio_req`` requests, interleaved,
    best of ``trials``)."""
    import threading

    from paddle_tpu_torch import observability as obs

    model = build_model(DEV, torch.bfloat16)
    cfg = ServingConfig(**(serving or LOAD_CFG), dtype=torch.bfloat16)
    vocab = model.cfg.vocab_size
    reqs = load_trace(vocab, n=n_req, **(trace or {}))
    names = ("serving_requests_total", "serving_requests_completed_total",
             "serving_tokens_generated_total")
    state = {}

    def before_run(sched):
        obs.configure(obs_dir)
        state["base"] = {k: obs.registry().total(k) for k in names}
        sched.start_http(0)
        state["scraper"] = Scraper(sched.http.url, (
            "/metrics", "/slo", "/healthz", "/debug/requests"), every=0.5)
        # the process's first capture sets up CUPTI: pay it before the trace
        code, body = http_get(sched.http.url + "/debug/profile?secs=0.05")
        require(code == 200, f"phase 25 (b): warm-up capture {code} {body}")
        state["profile"] = {}
        state["decodes"] = []

        def capture():
            t0 = time.perf_counter()
            state["profile"]["reply"] = http_get(
                sched.http.url + "/debug/profile?secs=1")
            state["profile"]["s"] = time.perf_counter() - t0

        state["profiler"] = threading.Thread(target=capture, daemon=True)
        decode = state["plain_decode"] = sched.engine.decode

        def timed_decode(*a):
            if not state["decodes"]:
                # the first tick starts the capture and waits until it
                # records, so the trace's ticks fill its window
                window = sched.http.profile_window
                window.clear()
                state["profiler"].start()
                t_wait = time.perf_counter()
                while "open" not in sched.http.profile_window:
                    require(time.perf_counter() - t_wait < 120,
                            "phase 25 (b): the profiler did not start")
                    time.sleep(0.001)
                state["profile"]["wait_s"] = time.perf_counter() - t_wait
                # and starts past the window's 1 ms margin: seen within a
                # millisecond of the opening, it fell outside the count
                # below, which then rested on the later ticks alone (on a
                # loaded host they can all end after the window)
                opened = sched.http.profile_window["open"]
                while time.time() < opened + 2e-3:
                    time.sleep(5e-4)
            t = time.time()
            out = decode(*a)
            state["decodes"].append((t, time.time()))
            return out

        sched.engine.decode = timed_decode

    slo = obs.SLOTracker()
    m, sched = serve_load(model, cfg, reqs, None, "traced",
                          before_run=before_run, tracer=obs.ServingTracer(),
                          slo=slo, stall_threshold_s=stall_s)
    counts["phase25_serve"] = m["launches"]
    state["profiler"].join()
    scraper = state["scraper"].stop()
    delta = {k: obs.registry().total(k) - state["base"][k] for k in names}
    own = [(r.t_first_token - r.t_submit) * 1e3 for r in reqs]
    docs = sched.tracer.snapshot()["finished_recent"]
    ttft_tracer = obs.nearest_rank([d["ttft_ms"] for d in docs], 0.5)
    ttft_own = obs.nearest_rank([round(x, 3) for x in own], 0.5)
    ticks = [r for r in jsonl_records(obs_dir) if r.get("kind") == "tick"]
    split = {k: float(np.median([t[k] for t in ticks]))
             for k in ("dur_ms", "admit_ms", "prefill_ms", "decode_ms",
                       "evict_ms")}
    split["host_ms"] = float(np.median(
        [t["dur_ms"] - t["prefill_ms"] - t["decode_ms"] for t in ticks]))
    dur = [t["dur_ms"] for t in ticks]
    tick_totals = {"dur_ms_sum": float(sum(dur)), "dur_ms_max": max(dur),
                   "decode_ms_sum": float(sum(t["decode_ms"] for t in ticks)),
                   "prefill_ms_sum": float(sum(t["prefill_ms"]
                                               for t in ticks))}
    sched.engine.decode = state["plain_decode"]
    code, body = state["profile"]["reply"]
    prof = json.loads(body)
    k_dec_events = (kernel_events(prof["path"], "paged_split_kernel")
                    if code == 200 and DEV.type == "cuda" else None)
    # decode ticks wholly inside the recording window (1 ms in from each
    # edge): each returns the host its logits, so its kernels ran inside
    w_open, w_close = prof.get("window") or (0.0, 0.0)
    ticks_inside = sum(1 for a, b in state["decodes"]
                       if a >= w_open + 1e-3 and b <= w_close - 1e-3)
    slo_doc = json.loads(scraper.last["/slo"][1])
    # the tick loop stops with work queued: not ready past the threshold
    url = sched.http.url
    sched.submit(Request(rid=n_req, prompt=reqs[0].prompt,
                         max_new_tokens=4))
    sched.step()
    time.sleep(stall_s + 0.5)
    wedged_code, wedged = http_get(url + "/healthz")
    live_code, _ = http_get(url + "/healthz?live")
    sched.run()
    after_code, _ = http_get(url + "/healthz")
    sched.stop_http()
    m.update({
        "counter_deltas": delta,
        "generated_tokens": sum(len(r.generated) for r in reqs),
        "ttft_ms_p50_tracer": ttft_tracer, "ttft_ms_p50_own": ttft_own,
        "ttft_ms_p50_slo_1m": slo_doc["slis"]["ttft_ms"]["windows"][
            "1m"]["p50"],
        "tick_split_ms_median": split, "ticks": len(ticks),
        "tick_totals_ms": tick_totals,
        "healthz_codes_during_trace": sorted(set(
            scraper.codes["/healthz"])),
        "healthz_wedged": [wedged_code, json.loads(wedged)["wedged"]],
        "healthz_live": live_code, "healthz_after": after_code,
        "profile": {"code": code, "s": state["profile"]["s"],
                    "wait_s": state["profile"].get("wait_s"),
                    "device_kernels": prof.get("device_kernels"),
                    "markers": prof.get("markers"),
                    "decode_ticks_inside": ticks_inside,
                    "k_dec_events": k_dec_events},
        "scrapes": {r: len(c) for r, c in scraper.codes.items()}})
    m["serving_trace_overhead_ratio"] = serve_overhead_ratio(
        sched.engine, vocab, ratio_req, trace, obs_dir, trials)
    log("  (b) serving: " + json.dumps(m))
    require(delta["serving_requests_total"] == n_req
            and delta["serving_requests_completed_total"] == n_req,
            f"phase 25 (b): {delta}")
    require(delta["serving_tokens_generated_total"]
            == m["generated_tokens"], f"phase 25 (b): {delta}")
    require(len(docs) == n_req and ttft_tracer == ttft_own,
            f"phase 25 (b): TTFT p50 {ttft_tracer} vs {ttft_own}")
    require(200 in scraper.codes["/healthz"]
            and m["healthz_wedged"] == [503, True] and live_code == 200
            and after_code == 200, f"phase 25 (b): healthz {m}")
    for route in ("/metrics", "/slo", "/debug/requests"):
        require(scraper.last[route][0] == 200, f"phase 25 (b): {route}")
    require(code == 200, f"phase 25 (b): /debug/profile {code} {prof}")
    require(ticks_inside > 0, "phase 25 (b): no decode tick ran inside "
            f"the profile capture's window {m['profile']}")
    if DEV.type == "cuda":
        layers = model.cfg.num_layers
        require(k_dec_events >= layers * ticks_inside,
                "phase 25 (b): the profile capture lacks K-DEC launches of "
                f"the decode ticks inside its window {m['profile']}")
    del model, sched
    torch.cuda.empty_cache()
    return m


def serve_overhead_ratio(eng, vocab, n_req, trace, obs_dir, trials):
    """``serving_trace_overhead_ratio``: the trace again on ``eng``,
    tracer and sink ON vs OFF, interleaved, best of ``trials``: ON
    output tokens/s over OFF's."""
    from paddle_tpu_torch import observability as obs

    def run(on):
        obs.configure(obs_dir if on else "")
        sched = ContinuousBatchingScheduler(
            eng, tracer=obs.ServingTracer() if on else None)
        reqs = load_trace(vocab, n=n_req, **(trace or {}))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        sched.run()
        torch.cuda.synchronize()
        return sum(len(r.generated) for r in reqs) / (
            time.perf_counter() - t0)

    best = {True: 0.0, False: 0.0}
    for _ in range(trials):
        for on in (False, True):
            best[on] = max(best[on], run(on))
    obs.configure(obs_dir)
    return best[True] / best[False]


def telemetry_checkpoint(obs_dir, layers=2) -> dict:
    """(c) One ``AsyncCheckpointManager`` save and one load of the train
    state of phase 24 (c)'s trainer (``layers`` layers at GPT-345M
    width): the counters move as the JAX package's do (bytes = the shard
    file written), the in-flight gauge is back at 0, the state loads
    back bitwise."""
    from paddle_tpu_torch import observability as obs

    reg = obs.registry()
    mcfg = dataclasses.replace(model_config(), num_layers=layers)
    t = hybrid.HybridParallelTrainer(mcfg, drill_config())
    state = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)) for k, v in t._flat_state().items()}
    del t
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_ckpt_")
    names = ("checkpoint_bytes_total", "checkpoint_saves_total",
             "checkpoint_loads_total")
    hists = ("checkpoint_manager_save_ms", "checkpoint_save_ms",
             "checkpoint_load_ms")
    base = {k: reg.total(k) for k in names}
    hbase = {k: reg.histogram(k).count for k in hists}
    gauge = reg.gauge("checkpoint_async_saves_in_flight", root=root)
    try:
        mgr = ckpt.AsyncCheckpointManager(root)
        t0 = time.perf_counter()
        path = mgr.save(state, 1)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        in_flight = gauge.value
        mgr.wait()
        shard = os.path.getsize(os.path.join(path, "shard-0.pkl"))
        step, loaded = mgr.load_latest()
        events = [r for r in jsonl_records(obs_dir)
                  if r.get("name") == "checkpoint_saved"
                  and r.get("path") == path]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m = {"shard_bytes": shard,
         "deltas": {k: reg.total(k) - base[k] for k in names},
         "histogram_counts": {k: reg.histogram(k).count - hbase[k]
                              for k in hists},
         "in_flight_after_save": in_flight, "in_flight_after_wait":
         gauge.value, "snapshot_ms": snapshot_ms,
         "saved_events": len(events), "step": step,
         "bitwise": loaded.keys() == state.keys() and all(
             np.array_equal(loaded[k], state[k]) for k in state)}
    log("  (c) checkpoint: " + json.dumps(m))
    require(m["deltas"] == {"checkpoint_bytes_total": shard,
                            "checkpoint_saves_total": 1,
                            "checkpoint_loads_total": 1},
            f"phase 25 (c): {m['deltas']}")
    require(m["histogram_counts"] == {"checkpoint_manager_save_ms": 1,
                                      "checkpoint_save_ms": 0,
                                      "checkpoint_load_ms": 1},
            f"phase 25 (c): {m['histogram_counts']}")
    require(m["in_flight_after_wait"] == 0 and m["saved_events"] == 1
            and m["bitwise"] and step == 1, f"phase 25 (c): {m}")
    return m


def phase_telemetry(counts, peaks, train=None, serve=None) -> dict:
    """Phase 25: run telemetry and the ops endpoint on the port's main
    paths, the JSONL sink in a temp dir (removed after)."""
    from paddle_tpu_torch import observability as obs

    log("[25] run telemetry: GPT-345M training and serving with the sink, "
        "the tracer, the SLO plane and the ops endpoint")
    t0 = time.perf_counter()
    obs_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        obs.configure(obs_dir)
        m = {"training": telemetry_train(counts, peaks, obs_dir,
                                         **(train or {})),
             "serving": telemetry_serve(counts, obs_dir, **(serve or {})),
             "checkpoint": telemetry_checkpoint(obs_dir)}
    finally:
        obs.configure("")
        shutil.rmtree(obs_dir, ignore_errors=True)
    m["s"] = time.perf_counter() - t0
    log(f"  {m['s']:.1f} s")
    return m


# -- phase 26: the rest of serving -------------------------------------------

# phase 26's fleet configuration: the pools of (d)-(e), 1024 pages of 16
# tokens, fp32 (3.2 GB each at GPT-345M)
FLEET_CFG = dict(page_size=16, max_model_len=256, max_batch=16,
                 max_prefill_tokens=1024, num_pages=1024)
# (f): a pool small enough that two tenants' bursts must preempt
TENANT_CFG = dict(page_size=16, max_model_len=64, max_batch=16,
                  max_prefill_tokens=1024, num_pages=24)
# phase 26's traces draw token ids below 1024 whatever the model's vocab,
# so a rehearsal at a tiny GPT schedules exactly what the card does
TRACE_VOCAB = 1024
# plan_kv_pool's page counts at an 80 GiB card, from the JAX function
PLAN_PAGES_80G = {("gpt_345m", "bf16"): 15571, ("gpt_345m", "int8"): 31022,
                  ("llama_7b", "bf16"): 180, ("llama_7b", "int8"): 359}


def mem_allocated():
    return torch.cuda.memory_allocated(DEV) if DEV.type == "cuda" else None


def mem_info():
    return (list(torch.cuda.mem_get_info(DEV)) if DEV.type == "cuda"
            else None)


def counted_tick(rep, per) -> bool:
    """One replica tick with the launches it made added to ``per``: the
    fleet's replicas tick one after another on this thread, so each
    delta is that replica's own."""
    before = K.launch_counts()
    ran = rep.tick()
    for name, n in K.launch_counts().items():
        per[name] = per.get(name, 0) + n - before[name]
    return ran


def stream_check(got, ref_tokens, ref_rows):
    """``None`` when ``got`` equals the reference stream, else ``(pos,
    gap)``: the first position where they part and the reference logits'
    top-2 gap there (a near-tie when under 1e-3)."""
    for i, (a, b) in enumerate(zip(got, ref_tokens)):
        if a != b:
            top2 = np.sort(ref_rows[i])[-2:]
            return i, float(top2[1] - top2[0])
    if len(got) != len(ref_tokens):
        return min(len(got), len(ref_tokens)), float("inf")
    return None


def hold_streams(what, streams, ref, exact=True) -> dict:
    """Every stream of ``streams`` (rid -> tokens) against the fused
    reference (rid -> (tokens, rows)): equal, or parted at a near-tie.
    With ``exact`` a parting off a near-tie fails the run."""
    same, near, off = 0, [], []
    for rid, toks in streams.items():
        part = stream_check(toks, *ref[rid])
        if part is None:
            same += 1
        elif part[1] < 1e-3:
            near.append((rid, *part))
        else:
            off.append((rid, *part))
    log(f"  {what}: {same} of {len(streams)} streams equal the fused "
        f"replica's, near-ties {near}, off near-ties {off}")
    if exact:
        require(not off, f"{what}: a stream parts from the fused replica's "
                f"off a near-tie: {off}")
    return {"identical": same, "near_ties": near, "off_near_ties": off}


def fleet_loadgen(counts, model, n_req=64, serving=None,
                  trace=None) -> dict:
    """(a) Phase 4's trace through ``run_continuous`` (a scheduler with a
    tracer) and ``run_static_baseline`` on one bf16 engine."""
    from paddle_tpu_torch.observability import (ServingTracer, nearest_rank,
                                                registry)
    from paddle_tpu_torch.serving import run_continuous, run_static_baseline

    cfg = ServingConfig(**(serving or LOAD_CFG), dtype=torch.bfloat16)
    vocab = model.cfg.vocab_size
    eng = ServingEngine(model, cfg)
    warm = ContinuousBatchingScheduler(eng, tracer=None)
    warm.submit(Request(rid=-1, prompt=load_trace(vocab, n=1, **(
        trace or {}))[0].prompt, max_new_tokens=8))
    warm.run()
    reqs = load_trace(vocab, n=n_req, **(trace or {}))
    sched = ContinuousBatchingScheduler(eng, tracer=ServingTracer())
    tok0 = registry().total("serving_tokens_generated_total")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    cont = run_continuous(eng, reqs, scheduler=sched)
    torch.cuda.synchronize()
    counts["phase26_cont"] = K.launch_counts()
    tokens = sum(len(r.generated) for r in sched.finished)
    require(cont["completed"] == n_req == len(sched.finished),
            f"phase 26 (a): {cont['completed']} of {n_req} finished")
    require(cont["total_tokens"] == tokens == registry().total(
        "serving_tokens_generated_total") - tok0
        == sum(r.max_new_tokens for r in reqs),
        f"phase 26 (a): report {cont['total_tokens']} tokens, scheduler "
        f"{tokens}")
    require(cont["decode_steps"] == sched._steps, "phase 26 (a): steps")
    layers = model.cfg.num_layers
    c = counts["phase26_cont"]
    require(c["K-SEG"] == len(sched.prefill_calls) * layers
            and c["K-DEC"] == len(sched.decode_tick_ms) * layers
            and c["K-SEG"] > 0 and c["K-DEC"] > 0 and c["K-BSHD"] == 0,
            f"phase 26 (a): continuous launches {c}")
    docs = sched.tracer.snapshot()["finished_recent"]
    tracer = {"ttft_ms_p50": nearest_rank([d["ttft_ms"] for d in docs], 0.5),
              "itl_ms_p50": nearest_rank(
                  [d["itl_ms_p50"] for d in docs if "itl_ms_p50" in d], 0.5)}
    sreqs = load_trace(vocab, n=n_req, **(trace or {}))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    static = run_static_baseline(eng, sreqs)
    torch.cuda.synchronize()
    counts["phase26_static"] = s = K.launch_counts()
    bs = cfg.max_batch
    batches = [sreqs[i:i + bs] for i in range(0, n_req, bs)]
    steps = sum(max(r.max_new_tokens for r in b) - 1 for b in batches)
    require(static["completed"] == n_req and all(
        len(r.generated) == r.max_new_tokens for r in sreqs),
        "phase 26 (a): the static baseline stopped short")
    require(s["K-BSHD"] == len(batches) * layers and s["K-SEG"] == 0
            and s["K-DEC"] == steps * layers,
            f"phase 26 (a): static launches {s}")
    require(eng.pool.in_use == 0, "phase 26 (a): leaked pages")
    same = sum(r.generated == q.generated for r, q in zip(
        sorted(reqs, key=lambda r: r.rid), sorted(sreqs,
                                                  key=lambda r: r.rid)))
    log("  (a) " + json.dumps({"continuous": cont, "static": static,
                               "tracer": tracer,
                               "static_streams_equal": same}))
    return {"continuous": cont, "static": static, "tracer": tracer,
            "static_streams_equal": same,
            "continuous_over_static_tokens_per_s": (
                cont["decode_tokens_per_sec"]
                / static["decode_tokens_per_sec"])}


def fleet_plans(plans=None, capacity=None, hbm_fraction=0.30) -> dict:
    """(b) ``plan_kv_pool`` for GPT-345M and LLaMA-7B at bf16 and int8
    against the card's capacity; a pool of each planned size is
    allocated alone (its bytes must be the plan's) and freed."""
    from paddle_tpu_torch.serving import PagedKVCache, plan_kv_pool

    cap = capacity if capacity is not None else hw.hbm_bytes(DEV)
    require(cap, "phase 26 (b): the card's capacity is unknown")
    plans = plans or [("gpt_345m", model_config()), ("llama_7b",
                                                      llama_config())]
    out = {}
    for name, mcfg in plans:
        for pool, kw in (("bf16", {"dtype": torch.bfloat16}),
                         ("int8", {"kv_dtype": "int8"})):
            plan = plan_kv_pool(mcfg, capacity_bytes=cap,
                                hbm_fraction=hbm_fraction, **kw)
            want = PLAN_PAGES_80G.get((name, pool))
            require(plan["num_pages"] >= 2, f"phase 26 (b): {name} {pool} "
                    f"plans {plan['num_pages']} pages")
            require(cap != 80 << 30 or want is None
                    or plan["num_pages"] == want,
                    f"phase 26 (b): {name} {pool} {plan['num_pages']} "
                    f"pages, the JAX function plans {want}")
            torch.cuda.synchronize()
            before = mem_info()
            kv = PagedKVCache(
                mcfg.num_layers, plan["num_pages"], 16,
                getattr(mcfg, "kv_heads", None) or mcfg.num_heads,
                mcfg.head_dim, dtype=kw.get("dtype"), device=DEV,
                kv_dtype=kw.get("kv_dtype", "fp32"))
            torch.cuda.synchronize()
            during = mem_info()
            require(kv.pool_bytes() == plan["kv_bytes"],
                    f"phase 26 (b): {name} {pool} pool {kv.pool_bytes()} "
                    f"bytes, plan {plan['kv_bytes']}")
            del kv
            torch.cuda.empty_cache()
            out[f"{name}_{pool}"] = {
                "num_pages": plan["num_pages"], "kv_bytes": plan["kv_bytes"],
                "state_bytes": plan["state_bytes"],
                "mem_get_info_before": before, "mem_get_info_after": during}
    log("  (b) " + json.dumps(out))
    return out


def fill_random(kv, gen):
    """Random bytes in every store of ``kv``, drop pages included."""
    for store in kv.k_stores + kv.v_stores + (kv.s_stores or []):
        store.view(torch.uint8).copy_(torch.randint(
            0, 256, store.view(torch.uint8).shape, dtype=torch.uint8,
            generator=gen).to(store.device))


def store_bytes(kv):
    return [s.view(torch.uint8).clone()
            for s in kv.k_stores + kv.v_stores + (kv.s_stores or [])]


def fleet_copy(num_pages=64) -> dict:
    """(c) ``copy_pages`` between two caches of the model's pool shape,
    bf16 and int8, filled with random bytes: the destination pages
    equal the source pages bitwise, scales included, with and without
    ``limit``; every other page and the drop pages keep their bytes;
    a CPU cache and a card cache never exchange pages."""
    from paddle_tpu_torch.serving import PagedKVCache, copy_pages

    mc = model_config()
    geo = (mc.num_layers, num_pages, 16, mc.num_heads, mc.head_dim)
    gen = torch.Generator().manual_seed(26)
    src_pages = [5, 1, 33, 17, 60, 2, 9]
    dst_pages = [40, 3, 12, 61, 7, 22, 50]
    out = {}
    for pool, kw in (("bf16", {"dtype": torch.bfloat16}),
                     ("int8", {"kv_dtype": "int8"})):
        for limit in (None, 3):
            src = PagedKVCache(*geo, device=DEV, **kw)
            dst = PagedKVCache(*geo, device=DEV, **kw)
            fill_random(src, gen)
            fill_random(dst, gen)
            s0, d0 = store_bytes(src), store_bytes(dst)
            n = copy_pages(src, dst, src_pages, dst_pages, limit=limit)
            want = len(src_pages) if limit is None else limit
            require(n == want, f"phase 26 (c): copied {n}, want {want}")
            s1, d1 = store_bytes(src), store_bytes(dst)
            moved = torch.tensor(dst_pages[:n], device=DEV)
            from_ = torch.tensor(src_pages[:n], device=DEV)
            keep = torch.ones(num_pages + 1, dtype=torch.bool, device=DEV)
            keep[moved] = False
            for a0, a1, b0, b1 in zip(s0, s1, d0, d1):
                require(torch.equal(a0, a1), "phase 26 (c): the source "
                        "changed")
                require(torch.equal(b1[moved], a0[from_]),
                        f"phase 26 (c): {pool} pages differ from the source")
                require(torch.equal(b1[keep], b0[keep]),
                        f"phase 26 (c): {pool} copy touched another page "
                        "or the drop page")
            out[f"{pool}_limit_{limit}"] = {
                "pages": n, "stores": len(d1),
                "bytes_per_page": sum(t[0].numel() for t in d1)}
            del src, dst, s0, d0, s1, d1
    if DEV.type == "cuda":
        cpu = PagedKVCache(*geo[:1], 4, *geo[2:], device="cpu")
        card = PagedKVCache(*geo[:1], 4, *geo[2:], device=DEV)
        try:
            copy_pages(cpu, card, [1], [1])
            require(False, "phase 26 (c): a CPU cache handed pages to the "
                    "card")
        except ValueError as e:
            out["cpu_to_card"] = str(e)
    log("  (c) " + json.dumps(out))
    return out


def fused_reference(model, cfg, reqs):
    """One fused scheduler over ``reqs`` (fresh copies): each rid's
    stream and the logits row behind each of its tokens."""
    eng = ServingEngine(model, ServingConfig(**cfg))
    sched = ContinuousBatchingScheduler(eng)
    copies = [Request(rid=r.rid, prompt=r.prompt.copy(),
                      max_new_tokens=r.max_new_tokens) for r in reqs]
    rows = record_logits(sched, copies)
    for r in copies:
        sched.submit(r)
    sched.run()
    require(eng.pool.in_use == 0, "phase 26: the reference leaked pages")
    return {r.rid: (list(r.generated), committed_rows(r, rows[r.rid]))
            for r in copies}


def disagg_run(model, cfg, reqs, kv_dtype="fp32", partial=None) -> tuple:
    """One prefill-role and one decode-role replica under a router and a
    ``DisaggCoordinator``, ticked by this thread; ``partial`` arms
    ``PADDLE_FI_HANDOFF_PARTIAL`` for that rid. Returns the streams, the
    coordinator's snapshot, each replica's launches and pool state."""
    from paddle_tpu_torch.serving import (DisaggCoordinator, LogicalRequest,
                                          Replica, ReplicaRouter,
                                          RouterConfig)

    scfg = ServingConfig(**cfg, kv_dtype=kv_dtype)
    if partial is not None:
        os.environ["PADDLE_FI_HANDOFF_PARTIAL"] = str(partial)
    try:
        pre = Replica("pre", lambda: ServingEngine(model, scfg),
                      role="prefill")
        dec = Replica("dec", lambda: ServingEngine(model, scfg),
                      role="decode")
        router = ReplicaRouter([pre, dec], cfg=RouterConfig(
            probe_interval_s=0.0))
        coord = DisaggCoordinator(router)
        lrs = [router.submit_request(LogicalRequest(
            rid=r.rid, prompt=r.prompt.copy(),
            max_new_tokens=r.max_new_tokens)) for r in reqs]
        per = {"pre": {}, "dec": {}}
        rounds = 0
        while router.in_flight:
            router.pump()
            counted_tick(pre, per["pre"])
            counted_tick(dec, per["dec"])
            rounds += 1
            require(rounds < 20000, "phase 26 (d): the split run stalled")
    finally:
        os.environ.pop("PADDLE_FI_HANDOFF_PARTIAL", None)
    require(all(lr.status == "finished" and len(lr.delivered)
                == lr.max_new_tokens for lr in lrs),
            f"phase 26 (d): {[(lr.rid, lr.status) for lr in lrs]}")
    pools = {rep.name: (rep.engine.pool.in_use, rep.engine.pool.leased)
             for rep in (pre, dec)}
    require(all(v == (0, 0) for v in pools.values()),
            f"phase 26 (d): pages left in use or leased {pools}")
    streams = {lr.rid: list(lr.delivered) for lr in lrs}
    out = {"snapshot": coord.snapshot(), "launches": per, "rounds": rounds,
           "redispatched": sorted(lr.rid for lr in lrs if lr.redispatches)}
    del pre, dec, router, coord
    return streams, out


def fleet_disagg(counts, model, ref, reqs, cfg) -> dict:
    """(d) The split run in fp32 against the fused replica, then int8
    pools, then a truncated handoff."""
    out = {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    streams, m = disagg_run(model, cfg, reqs)
    counts["phase26_disagg"] = K.launch_counts()
    pre, dec = m["launches"]["pre"], m["launches"]["dec"]
    snap = m["snapshot"]
    require(snap["handoffs_ok"] == len(reqs) and snap["handoffs_failed"] == 0
            and snap["active"] == 0, f"phase 26 (d): {snap}")
    require(pre.get("K-SEG", 0) > 0 and pre.get("K-DEC", 0) == 0
            and dec.get("K-DEC", 0) > 0,
            f"phase 26 (d): prefill {pre}, decode {dec}")
    m["streams"] = hold_streams("(d) fp32 split", streams, ref)
    out["fp32"] = m
    K.reset_launch_counts()
    streams, m = disagg_run(model, cfg, reqs, kv_dtype="int8")
    counts["phase26_disagg_int8"] = K.launch_counts()
    dec = m["launches"]["dec"]
    require(dec.get("K-DEC8", 0) > 0 and dec.get("K-DEC", 0) == 0
            and m["snapshot"]["handoffs_ok"] == len(reqs),
            f"phase 26 (d): int8 {m['launches']} {m['snapshot']}")
    m["streams"] = hold_streams("(d) int8 split", streams, ref, exact=False)
    out["int8"] = m
    ps = cfg["page_size"]
    victim = max(reqs, key=lambda r: len(r.prompt))
    require(len(victim.prompt) > ps, "phase 26 (d): no request spans two "
            "pages")
    K.reset_launch_counts()
    streams, m = disagg_run(model, cfg, reqs, partial=victim.rid)
    counts["phase26_disagg_partial"] = K.launch_counts()
    snap = m["snapshot"]
    require(snap["handoffs_failed"] == 1 and snap["re_prefills"] == 1
            and snap["handoffs_ok"] == len(reqs) - 1
            and m["redispatched"] == [victim.rid],
            f"phase 26 (d): partial transfer {snap} {m['redispatched']}")
    require(m["launches"]["dec"].get("K-SEG", 0) > 0,
            "phase 26 (d): the victim did not re-prefill on the decode "
            "replica")
    m["streams"] = hold_streams("(d) truncated handoff", {
        victim.rid: streams[victim.rid]}, ref)
    out["partial"] = m
    log("  (d) " + json.dumps(out))
    return out


class CreepClock:
    """A virtual clock that moves 1 ms on every read: ages and EMAs move,
    and a wedge of a few virtual seconds passes in a bounded number of
    reads."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def fleet_drill(counts, model, ref, reqs, cfg, kill_tick=4, wedge_tick=14,
                wedge_s=0.5) -> dict:
    """(e) Two fused replicas on a virtual clock: ``a`` is killed
    mid-decode (``router_kill_replica``), then ``b`` wedges briefly
    (``router_wedge_replica``). Every logical request finishes, no
    delivered token repeats (each harvest only extends the stream), fp32
    streams equal the fused replica's by (d)'s rule, and after
    ``a.restart()`` the card's allocated bytes are back within one
    pool's bytes of their value before the kill."""
    from paddle_tpu_torch.serving import (LogicalRequest, Replica,
                                          ReplicaRouter, RouterConfig)

    scfg = ServingConfig(**cfg)
    clk = CreepClock()
    fi_dir = tempfile.mkdtemp(prefix="chip_smoke_fi_")
    env = {"PADDLE_FI_DIR": fi_dir,
           "PADDLE_FI_ROUTER_KILL_REPLICA": f"a:{kill_tick}",
           "PADDLE_FI_ROUTER_WEDGE_REPLICA": f"b:{wedge_tick}:{wedge_s}"}
    os.environ.update(env)
    try:
        reps = [Replica(n, lambda: ServingEngine(model, scfg), clock=clk)
                for n in ("a", "b")]
        a, b = reps
        router = ReplicaRouter(reps, clock=clk, cfg=RouterConfig(
            probe_interval_s=0.0, breaker_failures=1))
        torch.cuda.synchronize()
        # the earlier sub-phases' replicas may still wait in reference
        # cycles: freed now, not at whatever point the collector runs
        gc.collect()
        mem_before = mem_allocated()
        pool_bytes = a.engine.kv.pool_bytes()
        lrs = [router.submit_request(LogicalRequest(
            rid=r.rid, prompt=r.prompt.copy(),
            max_new_tokens=r.max_new_tokens)) for r in reqs]
        seen = {lr.rid: [] for lr in lrs}
        per = {"a": {}, "b": {}}
        K.reset_launch_counts()
        rounds = 0
        while router.in_flight:
            router.pump()
            for lr in lrs:
                d = list(lr.delivered)
                require(d[:len(seen[lr.rid])] == seen[lr.rid],
                        f"phase 26 (e): rid {lr.rid}'s delivered tokens "
                        "were rewritten")
                seen[lr.rid] = d
            for rep in reps:
                counted_tick(rep, per[rep.name])
            rounds += 1
            require(rounds < 50000, "phase 26 (e): the fleet stalled")
        counts["phase26_fleet"] = K.launch_counts()
    finally:
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(fi_dir, ignore_errors=True)
    snap = router.snapshot()
    require(a.state == "dead" and a.engine is None
            and snap["re_dispatches"] > 0,
            f"phase 26 (e): a was not killed mid-decode {snap}")
    require("wedged" in snap["replicas"]["b"]["history"],
            f"phase 26 (e): b never read wedged {snap['replicas']['b']}")
    require(all(lr.status == "finished" and len(lr.delivered)
                == lr.max_new_tokens for lr in lrs),
            f"phase 26 (e): {[(lr.rid, lr.status) for lr in lrs]}")
    require(b.engine.pool.in_use == 0, "phase 26 (e): b leaked pages")
    streams = hold_streams("(e) fleet", {lr.rid: list(lr.delivered)
                                         for lr in lrs}, ref)
    a.restart()
    torch.cuda.synchronize()
    gc.collect()
    mem_after = mem_allocated()
    if mem_before is not None:
        require(abs(mem_after - mem_before) < pool_bytes,
                f"phase 26 (e): {mem_after - mem_before} bytes more after "
                f"the restart than before the kill (one pool is "
                f"{pool_bytes})")
    out = {"rounds": rounds, "re_dispatches": snap["re_dispatches"],
           "history": {n: r["history"] for n, r in snap["replicas"].items()},
           "generation_a": a.generation, "launches": per,
           "streams": streams, "mem_before_kill": mem_before,
           "mem_after_restart": mem_after, "pool_bytes": pool_bytes}
    del reps, a, b, router
    log("  (e) " + json.dumps(out))
    return out


def fleet_threaded(counts, model, ref, reqs, cfg, n=4,
                   limit_s=120.0) -> dict:
    """(e) continued: two fused replicas on tick threads of their own
    (``Replica.start``; each thread sets the engine's device first), the
    router pumped from this thread: ``n`` requests finish with the fused
    replica's streams by (d)'s rule, and the pools drain."""
    from paddle_tpu_torch.serving import (LogicalRequest, Replica,
                                          ReplicaRouter, RouterConfig)

    scfg = ServingConfig(**cfg)
    reps = [Replica(name, lambda: ServingEngine(model, scfg)).start()
            for name in ("t0", "t1")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        router = ReplicaRouter(reps, cfg=RouterConfig(
            probe_interval_s=0.005))
        lrs = [router.submit_request(LogicalRequest(
            rid=r.rid, prompt=r.prompt.copy(),
            max_new_tokens=r.max_new_tokens)) for r in reqs[:n]]
        while router.in_flight:
            router.pump()
            time.sleep(0.002)
            require(time.perf_counter() - t0 < limit_s,
                    f"phase 26 (e): threaded fleet stalled "
                    f"{router.snapshot()}")
    finally:
        for rep in reps:
            rep.stop()
    counts["phase26_threaded"] = K.launch_counts()
    require(all(lr.status == "finished" for lr in lrs)
            and all(rep.engine.pool.in_use == 0 for rep in reps),
            "phase 26 (e): the threaded fleet left work or pages")
    streams = hold_streams("(e) threaded", {lr.rid: list(lr.delivered)
                                            for lr in lrs}, ref)
    out = {"s": time.perf_counter() - t0, "streams": streams}
    del reps, router
    log("  (e) threaded " + json.dumps(out))
    return out


def fleet_tenancy(counts, model, n_per_tenant=16) -> dict:
    """(f) Two tenants on one replica, both bursting
    (``multi_tenant_trace``): ``gold`` (priority 1, weight 2, a floor of
    8 pages that is also its quota) is never preempted while ``batch``
    (rate-limited) is; ``batch`` is shed ``tenant_rate`` with its
    bucket's exact refill time as the hint, and the shed request is
    admitted once the clock has moved by it; ``/healthz`` lists both
    tenants and ``/slo?tenant=gold`` answers the keyed view."""
    from paddle_tpu_torch.observability import SLOTracker
    from paddle_tpu_torch.serving import (RejectedError, Replica, Tenant,
                                          TenantRegistry, multi_tenant_trace)

    clk = CreepClock()
    reg = TenantRegistry([
        Tenant("gold", weight=2.0, priority=1, guaranteed_pages=8,
               max_resident_pages=8),
        Tenant("batch", priority=0, rate_tokens_per_s=200.0,
               burst_tokens=300.0)])
    scfg = ServingConfig(**TENANT_CFG)
    rep = Replica("t", lambda: ServingEngine(model, scfg),
                  make_scheduler=lambda eng: ContinuousBatchingScheduler(
                      eng, clock=clk, tenancy=reg,
                      slo=SLOTracker(clock=clk)), clock=clk)
    sched = rep.scheduler
    reqs = multi_tenant_trace(n_per_tenant, seed=26,
                              tenants=(("gold", 1.0), ("batch", 1.0)),
                              vocab_size=TRACE_VOCAB)
    bucket = reg.tenants["batch"].bucket
    shed, honoured = [], None
    for r in reqs:
        try:
            rep.submit(r)
        except RejectedError as e:
            shed.append((r.rid, e.reason, e.tenant, e.retry_after_s))
            if honoured is None:
                # the hint is the bucket's refill time for the deficit;
                # once the clock has moved by it, the bucket admits
                cost = len(r.prompt) + r.max_new_tokens
                exact = max((cost - bucket.level) / bucket.rate, 1e-3)
                require(abs(e.retry_after_s - exact) < 1e-9,
                        f"phase 26 (f): hint {e.retry_after_s}, the "
                        f"bucket's refill time {exact}")
                clk.t += e.retry_after_s
                rep.submit(r)
                honoured = r
    require(honoured is not None and all(
        s[1:3] == ("tenant_rate", "batch") for s in shed),
        f"phase 26 (f): sheds {shed}")
    sched.start_http(0)
    K.reset_launch_counts()
    try:
        rep.tick()
        code, body = http_get(f"{sched.http.url}/healthz")
        tenants = json.loads(body).get("tenants", {})
        require(code in (200, 503) and set(tenants) == {"gold", "batch"},
                f"phase 26 (f): /healthz tenants {code} {tenants}")
        while rep.tick():
            pass
        code, body = http_get(f"{sched.http.url}/slo?tenant=gold")
        keyed = json.loads(body)
        require(code == 200 and keyed.get("tenant") == "gold"
                and keyed.get("known") is True and "slis" in keyed,
                f"phase 26 (f): /slo?tenant=gold {code} {keyed}")
    finally:
        sched.stop_http()
    counts["phase26_tenancy"] = K.launch_counts()
    snap = reg.snapshot()
    require(snap["gold"]["preemptions"] == 0
            and snap["batch"]["preemptions"] > 0,
            f"phase 26 (f): preemptions {snap}")
    done = [r for r in sched.finished if r.status == "finished"]
    require(len(done) == len(reqs) - len(shed) + 1
            and honoured.status == "finished"
            and rep.engine.pool.in_use == 0,
            f"phase 26 (f): {len(done)} finished of {len(reqs)}, "
            f"{len(shed)} shed")
    out = {"tenants": snap, "shed": shed, "healthz_tenants": tenants,
           "slo_gold_known": keyed["known"]}
    log("  (f) " + json.dumps(out))
    return out


def phase_fleet(counts, load=None, plans=None, n_disagg=8) -> dict:
    """Phase 26: the rest of serving on the card (loadgen, pool plans,
    page copies, disaggregated prefill/decode, the replica fleet under
    chaos, tenancy); every model is GPT-345M (``model_config()``)."""
    from paddle_tpu_torch.serving import synthetic_trace

    log("[26] the rest of serving: loadgen, pool plans, page copies, "
        "disaggregation, the fleet, tenancy")
    t0 = time.perf_counter()
    out = {}
    model = build_model(DEV, torch.bfloat16)
    out["loadgen"] = fleet_loadgen(counts, model, **(load or {}))
    del model
    torch.cuda.empty_cache()
    out["plans"] = fleet_plans(**(plans or {}))
    out["copy"] = fleet_copy()
    model = build_model(DEV, torch.float32)
    reqs = synthetic_trace(n_disagg, seed=26, vocab_size=TRACE_VOCAB)
    ref = fused_reference(model, FLEET_CFG, reqs)
    out["disagg"] = fleet_disagg(counts, model, ref, reqs, FLEET_CFG)
    out["drill"] = fleet_drill(counts, model, ref, reqs, FLEET_CFG)
    out["threaded"] = fleet_threaded(counts, model, ref, reqs, FLEET_CFG)
    out["tenancy"] = fleet_tenancy(counts, model)
    del model, ref
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    log(f"  {out['s']:.1f} s")
    return out


# -- phase 27: multi-rank training over torch.distributed ---------------------
#
# A world of ranks sharing the one card over gloo (NCCL cannot put two
# ranks of one communicator on one card). Each rank is a process of this
# script (``--rank-worker SPEC``); the spec names every sub-phase, its
# model, layout, batch and dtype, so the CPU rehearsal runs the same code.

RANKS = 4
# sub-phase -> (family, layers, mesh layout, batch (B, S), dtype, steps)
MULTIRANK = {
    "a": ("gpt", 1, dict(mp=2, sep=2), (2, 1024), "float32", 2),
    "b": ("gpt", 2, dict(dp=2, sharding=2, zero_stage=3), (4, 1024),
          "float32", 2),
    "c": ("llama", 1, dict(sep=2, sharding=2, zero_stage=3), (2, 2048),
          "float32", 2),
    "d": ("gpt", 1, dict(mp=2, sep=2), (2, 1024), "bfloat16", 5),
    "e": ("gpt", 2, dict(dp=2, mp=2, packed_sequences=True), (4, 1024),
          "float32", 2),
    "f": ("gpt", 1, dict(mp=2, sep=2, ring_attention=False), (2, 1024),
          "float32", 2),
    "g": ("llama", 1, dict(sep=2, sharding=2, zero_stage=3,
                           ring_attention=False), (2, 2048), "float32", 2),
    "h": ("gpt", 2, dict(dp=2, mp=2, packed_sequences=True), (4, 1024),
          "bfloat16", 5),
}
# the sub-phases held to another's losses (the ring's) at 1e-5
SAME_LOSSES = {"f": "a", "g": "c"}
# phase 27's packed rows: documents of 32..1024 tokens (numpy seed 27)
PACKED_DOCS = (32, 1024)


# phase 28's sub-phases, in the same form: the pipelined layouts
PIPELINE = {
    "a": ("gpt", 4, dict(pp=4, micro_batches=4), (4, 1024), "float32", 2),
    "b": ("gpt", 4, dict(pp=2, mp=2, pp_schedule="gpipe", micro_batches=2),
          (2, 1024), "float32", 2),
    "c": ("gpt", 4, dict(pp=2, vpp=2, dp=2, micro_batches=4, remat=False),
          (8, 1024), "float32", 2),
    "d": ("llama", 2, dict(pp=2, sep=2, micro_batches=2), (2, 2048),
          "float32", 2),
    "e": ("gpt", 24, dict(pp=4, micro_batches=8, remat=False), (8, 1024),
          "bfloat16", 4),
    "e-gpipe": ("gpt", 24, dict(pp=4, micro_batches=8, remat=False,
                                pp_schedule="gpipe"), (8, 1024), "bfloat16",
                2),
}


def multirank_config(dtype, **layout):
    """The sub-phases' trainer: phase 7's fp32 schedule, remat and the
    guard on, Adam's eps at 1e-3. A sharded sum and a single-rank sum of
    one grad differ by their rounding (~1e-8 here), and where the true
    grad is ~0 (the k part of ``qkv_b``: softmax ignores a bias shared by
    every key) Adam turns that gap into a step gap of up to
    ``lr * dg / eps``: at eps 1e-5 the zero-initialised biases ended 3
    steps 1.5e-4 (``mp=2, sep=2``) and 3.0e-4 (ZeRO 3) of their largest
    value apart while the losses agreed to 1e-7; at 1e-3 that gap is
    ~100x smaller."""
    return hybrid.TrainerConfig(compute_dtype=getattr(torch, dtype),
                                learning_rate=1e-3, warmup_steps=2,
                                total_steps=10, eps=1e-3, **layout)


def _remat_forwards(remat) -> int:
    """How often a layer's attention forward runs under a per-layer
    ``remat`` policy: once without recompute or where the policy saves
    the kernel's outputs, else twice."""
    if remat in (False, None, "none"):
        return 1
    if isinstance(remat, str) and remat.startswith("names:"):
        names = set(remat[len("names:"):].split(","))
        return 1 if {"attn_out_kernel", "attn_lse"} <= names else 2
    return 2


def pipe_launches(layers, pp, vpp, micro_batches, sep, remat, steps,
                  schedule="1f1b") -> dict:
    """The launches a rank makes in ``steps`` pipelined steps, derived
    from the schedules (``parallel/pipeline.py``): each of the M
    microbatches passes the rank's ``layers / pp`` layers once forward
    and once backward (in ``vpp`` chunks of ``layers / (vpp*pp)`` under
    the interleaved schedule), each layer's attention ``sep + 2`` blocks
    on a zigzag ring of ``sep`` ranks, else 1. 1F1B and interleaved
    forwards run twice under any remat policy (a forward without a graph,
    then the backward's recompute) and once without; GPipe's follow the
    per-layer policy (:func:`_remat_forwards`)."""
    per = sep + 2 if sep > 1 else 1
    passes = steps * micro_batches * (layers // pp) * per
    if schedule == "gpipe":
        fwd = _remat_forwards(remat)
    else:
        fwd = 1 if remat in (False, None, "none") else 2
    return {"K-PACK": passes * fwd, "K-DQ": passes, "K-DKV": passes}


def _naive_ring(layout) -> bool:
    """``sep > 1`` with ``ring_attention=False``: contiguous shards, the
    naive ring (``parallel/hybrid.py``'s ``_ring_for``)."""
    return layout.get("sep", 1) > 1 and not layout.get("ring_attention",
                                                       True)


def world_launches(layers, layout, steps, sep_rank=0) -> dict:
    """The launches rank ``sep_rank`` of ``"sep"`` makes: :func:`mesh_
    launches` for packed rows, :func:`ring_launches` on the zigzag ring,
    :func:`pipe_launches` for a pipelined layout; on the naive ring
    (``ring_attention=False``) rank r runs the causal diagonal block and
    one full block for each earlier shard, 1 + r blocks a layer where a
    layer without a ring runs 1."""
    pp = layout.get("pp", 1)
    if pp == 1 and layout.get("packed_sequences"):
        return mesh_launches(layers, layout, steps)
    naive = _naive_ring(layout)
    sep = 1 if naive else layout.get("sep", 1)
    if pp == 1:
        per = ring_launches(layers, sep, steps)
    else:
        per = pipe_launches(layers, pp, layout.get("vpp", 1),
                            layout.get("micro_batches") or 2 * pp, sep,
                            layout.get("remat", True), steps,
                            layout.get("pp_schedule", "1f1b"))
    blocks = 1 + sep_rank if naive else 1
    return {k: v * blocks for k, v in per.items()}


def mesh_launches(layers, layout, steps) -> dict:
    """The launches a rank makes in ``steps`` steps on packed rows,
    derived from the code (``parallel/hybrid.py``): each layer runs one
    K-SEG, K-SDQ and K-SDKV over the rank's heads. The per-layer
    ``remat`` policy runs each forward twice, once without recompute or
    where it saves the kernel's outputs (:func:`_remat_forwards`)."""
    n = steps * layers
    return {"K-SEG": n * _remat_forwards(layout.get("remat", True)),
            "K-SDQ": n, "K-SDKV": n}


def ring_launches(layers, sep, steps, remat=True) -> dict:
    """The launches a rank makes in ``steps`` steps, derived from the
    rings' loops (``ops/ring_attention.py``). The zigzag ring's forward
    runs 3 K-PACK at t = 0 (chunk i causal, chunk 2n-1-i against chunk i
    full and itself causal) and 1 at each of the n-1 later steps
    (step_lo or step_hi): n + 2 a layer; its backward runs the same
    blocks as K-DQ and as K-DKV: n + 2 each. remat runs each layer's
    forward twice. Without a ring (sep 1) a layer runs 1 of each."""
    per = sep + 2 if sep > 1 else 1
    return {"K-PACK": steps * layers * per * (2 if remat else 1),
            "K-DQ": steps * layers * per, "K-DKV": steps * layers * per}


def ring_block_shapes(runs=None) -> list:
    """The ring blocks of the sub-phases with ``sep > 1`` (``runs``, else
    phases 27 and 28's), as ``(dtype, B, Sq, Sk, NH, d, causal)`` at a
    rank's batch (a microbatch's rows in a pipeline) and heads and the
    zigzag chunk L = S / (2 sep): the diagonal L x L causal, the L x L
    full block of t = 0, step_hi's L x 2L and step_lo's 2L x L; on the
    naive ring, at the shard c = S / sep, the c x c causal diagonal and
    the c x c full block (phase 2 holds each to its plain version)."""
    shapes = set()
    specs = (runs.values() if runs else
             [*MULTIRANK.values(), *PIPELINE.values()])
    for family, _, layout, (b, s), dtype, _ in specs:
        sep = layout.get("sep", 1)
        if sep == 1:
            continue
        mcfg = _model_of(family, 1)
        lb = b // (layout.get("dp", 1) * layout.get("sharding", 1))
        pp = layout.get("pp", 1)
        if pp > 1:
            lb //= layout.get("micro_batches") or 2 * pp
        nh = mcfg.num_heads // layout.get("mp", 1)
        if _naive_ring(layout):
            c = s // sep
            blocks = ((c, c, True), (c, c, False))
        else:
            L = s // sep // 2
            blocks = ((L, L, True), (L, L, False), (L, 2 * L, False),
                      (2 * L, L, False))
        for sq, sk, causal in blocks:
            shapes.add((dtype, lb, sq, sk, nh, mcfg.head_dim, causal))
    return sorted(shapes)


def mesh_seg_shapes(runs=None) -> list:
    """The packed sub-phases' K-SEG, K-SDQ and K-SDKV shapes (``runs``,
    else phase 27's), as ``(dtype, B, S, NH, d)`` at a rank's rows and
    heads (phase 2 holds each to its plain version on rows packed like
    the sub-phases')."""
    shapes = set()
    for family, _, layout, (b, s), dtype, _ in (runs or MULTIRANK).values():
        if not layout.get("packed_sequences"):
            continue
        mcfg = _model_of(family, 1)
        lb = b // (layout.get("dp", 1) * layout.get("sharding", 1))
        shapes.add((dtype, lb, s, mcfg.num_heads // layout.get("mp", 1),
                    mcfg.head_dim))
    return sorted(shapes)


def _model_of(family, layers):
    base = model_config() if family == "gpt" else llama_config()
    return dataclasses.replace(base, num_layers=layers)


def _init_path(work, family, layers) -> str:
    return os.path.join(work, f"init-{family}-{layers}.pt")


def multirank_batch(layout, seed, b, s, vocab) -> tuple:
    """A sub-phase's global batch, the arguments of ``step``: random
    tokens with their shifted labels (:func:`train_batch`, numpy
    ``seed``) or, for packed rows, ``b`` rows packed by ``io.packing``
    from documents of ``PACKED_DOCS`` tokens (:func:`packed_rows`, the
    same seed): tokens, labels, segment ids and positions."""
    if layout.get("packed_sequences"):
        return packed_rows(seed, b, s, *PACKED_DOCS, vocab)[0]
    return train_batch(np.random.RandomState(seed), b, s, vocab)


def _reference_key(spec) -> tuple:
    """What a sub-phase's single-rank reference depends on: sub-phases
    that differ only in their mesh share one."""
    family, layers, layout, batch, dtype, steps = spec
    return (family, layers, tuple(batch), dtype, steps,
            layout.get("zero_stage", 1), layout.get("remat", True),
            bool(layout.get("packed_sequences")))


def multirank_trainer(spec, work):
    """A sub-phase's single-device trainer on the card, its weights
    written to ``work/init-<family>-<layers>.pt`` (once a model) for the
    world's ranks to start from."""
    family, layers, layout, _, dtype, _ = spec
    t = hybrid.HybridParallelTrainer(
        _model_of(family, layers),
        multirank_config(dtype, zero_stage=layout.get("zero_stage", 1),
                         remat=layout.get("remat", True),
                         packed_sequences=layout.get("packed_sequences",
                                                     False)),
        device=DEV)
    init = _init_path(work, family, layers)
    if not os.path.exists(init):
        torch.save(dict(flatten(t.full_params())), init)
    return t


def multirank_reference(spec, work, seed=27) -> dict:
    """A sub-phase on one rank of the card: the single-device trainer
    from the seed's weights (:func:`multirank_trainer`), under the
    sub-phase's remat policy, on the same batch (numpy ``seed``): losses,
    grad norms and the final params (on the CPU)."""
    family, layers, layout, (b, s), dtype, steps = spec
    t0 = time.perf_counter()
    t = multirank_trainer(spec, work)
    batch = multirank_batch(layout, seed, b, s, t.model_cfg.vocab_size)
    losses, gnorms = [], []
    for _ in range(steps):
        losses.append(float(t.step(*batch)))
        gnorms.append(float(t.last_grad_norm))
    params = dict(flatten(t.full_params()))
    del t
    torch.cuda.empty_cache()
    return {"losses": losses, "gnorms": gnorms, "params": params,
            "s": time.perf_counter() - t0}


def _count_plain_versions():
    """On the CPU (the rehearsal) the packed plain versions stand for the
    kernels and count as them."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    for name, ref in (("K-PACK", "packed_attention_ref"),
                      ("K-DQ", "packed_dq_ref"), ("K-DKV", "packed_dkv_ref"),
                      ("K-SEG", "segment_attention_ref"),
                      ("K-SDQ", "segment_dq_ref"),
                      ("K-SDKV", "segment_dkv_ref")):
        orig = getattr(fp, ref)

        def counted(*a, _orig=orig, _name=name, **kw):
            fp.LAUNCHES[_name] += 1
            return _orig(*a, **kw)

        setattr(fp, ref, counted)


def check_collectives(mesh) -> dict:
    """The world's collectives on this rank's device against the values
    they must give: all-reduce and broadcast (gloo's own CUDA path), and
    the host-staged all-gather, reduce-scatter and ring shift."""
    from paddle_tpu_torch.distributed import communication as comm

    r, n, dev = mesh.rank, mesh.world, mesh.device
    world = mesh.world_group
    x = torch.arange(6, dtype=torch.float32, device=dev) + r
    got = {}
    ar = comm.all_reduce(x.clone(), group=world)
    got["all_reduce"] = bool(torch.equal(
        ar.cpu(), torch.arange(6.) * n + n * (n - 1) / 2))
    bc = comm.broadcast(x.clone(), src=n - 1, group=world)
    got["broadcast"] = bool(torch.equal(bc.cpu(), torch.arange(6.) + n - 1))
    ag = comm.all_gather_dim(x[None], 0, world)
    got["all_gather"] = bool(torch.equal(
        ag.cpu(), torch.arange(6.)[None] + torch.arange(float(n))[:, None]))
    rs = comm.scatter_dim(torch.ones(n, 3, device=dev) * (r + 1), 0, world)
    got["reduce_scatter"] = bool(torch.equal(
        rs.cpu(), torch.full((1, 3), n * (n + 1) / 2)))
    (sh,) = comm.ring_shift([x], world, (r + 1) % n, (r - 1) % n,
                            host_staged=mesh.host_staged)
    got["ring_shift"] = bool(torch.equal(sh.cpu(),
                                         torch.arange(6.) + (r - 1) % n))
    return got


def multirank_worker(spec_json: str) -> int:
    """``chip_smoke.py --rank-worker SPEC``: one rank of phase 27's or
    28's world (gloo over ``spec["init"]``) running every sub-phase of
    the spec, each from its model's reference weights where a reference
    wrote them, else from the trainer's seed; it writes its results to
    ``spec["dir"]/rank<r>.json`` and, rank 0, each compared sub-phase's
    gathered params to ``params-<name>.pt``."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.observability.memory import plan_state_memory
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.parallel import pipeline

    spec = json.loads(spec_json)
    rank, world = spec["rank"], spec["world"]
    dev = torch.device(spec["device"])
    torch.set_num_threads(spec["threads"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)    # every rank: one card
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load_library()
    else:
        _count_plain_versions()
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=world, rank=rank)
    mesh = build_mesh(dp=world, device=dev)
    out = {"mesh": repr(mesh), "collectives": check_collectives(mesh)}
    for name, (family, layers, layout, (b, s), dtype, steps) in (
            spec["runs"].items()):
        mcls = GPTConfig if family == "gpt" else type(llama_config())
        mcfg = mcls(**spec["models"][family])
        mcfg = dataclasses.replace(mcfg, num_layers=layers)
        tcfg = multirank_config(dtype, **layout)
        t0 = time.perf_counter()
        path = _init_path(spec["dir"], family, layers)
        init = (_unflat(torch.load(path, mmap=True))
                if os.path.exists(path) else None)
        t = hybrid.HybridParallelTrainer(mcfg, tcfg, device=dev,
                                         params=init)
        del init
        build_s = time.perf_counter() - t0
        live = sum(x.numel() * x.element_size()
                   for _, x in flatten({"p": t.params, "o": t.opt}))
        batch = multirank_batch(layout, spec["seed"], b, s, mcfg.vocab_size)
        K.reset_launch_counts()
        ra.BLOCKS.clear()
        pipeline.reset_counters()
        losses, gnorms, step_s = [], [], []
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            loss = t.step(*batch)
            losses.append(float(loss))
            gnorms.append(float(t.last_grad_norm))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t1)
        res = {"losses": losses, "gnorms": gnorms, "step_s": step_s,
               "build_s": build_s,
               "launches": K.launch_counts(),
               "blocks": [[*k, v] for k, v in sorted(ra.BLOCKS.items())],
               "live_state_bytes": live,
               "stage": t.mesh.coords["pipe"],
               "sep_rank": t.mesh.coords["sep"],
               "in_flight": pipeline.COUNTERS["in_flight_max"],
               "chunk_bytes_sent": pipeline.COUNTERS["chunk_bytes_sent"],
               "planned_bytes": plan_state_memory(mcfg, tcfg)[
                   "total_per_device_bytes"],
               "max_memory_allocated_gb": (
                   torch.cuda.max_memory_allocated(dev) / 1e9
                   if dev.type == "cuda" else 0.0)}
        if name in spec["compare"]:
            t1 = time.perf_counter()
            params = t.full_params()
            if rank == 0:
                torch.save(dict(flatten(params)),
                           os.path.join(spec["dir"], f"params-{name}.pt"))
            del params
            res["gather_save_s"] = time.perf_counter() - t1
        out[name] = res
        del t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _unflat(flat):
    """``{path tuple: leaf}`` back into the nested params."""
    from paddle_tpu_torch.utils.tree import unflatten

    return unflatten(flat.items())


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_world(spec, world) -> dict:
    """Start ``world`` rank workers of ``spec``, their output in files
    of ``spec["dir"]`` (a pipe nobody reads until the end would stall a
    rank that fills it); :func:`wait_world` waits for them."""
    spec = dict(spec, init=f"tcp://127.0.0.1:{_free_port()}", world=world)
    env = dict(os.environ, OMP_NUM_THREADS=str(spec["threads"]))
    outs = [open(os.path.join(spec["dir"], f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker",
         json.dumps(dict(spec, rank=r))], env=env, stdout=outs[r],
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return {"spec": spec, "procs": procs, "outs": outs,
            "t0": time.perf_counter()}


def stop_world(started) -> list:
    """Kill the started world's workers still running; the tail of each
    one's output (read once)."""
    if "logs" not in started:
        for p in started["procs"]:
            if p.poll() is None:
                p.kill()
            p.wait()
        started["logs"] = []
        for f in started["outs"]:
            f.seek(0)
            started["logs"].append(f.read()[-3000:])
            f.close()
    return started["logs"]


def wait_world(started, timeout=300) -> tuple:
    """Wait for a started world; a worker that fails ends the others.
    Returns each rank's result and the world's seconds."""
    spec, procs, t0 = started["spec"], started["procs"], started["t0"]
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                failed = bad[0] if bad else None
                break
            time.sleep(0.2)
    finally:
        logs = stop_world(started)
    secs = time.perf_counter() - t0
    if failed is not None or any(p.returncode for p in procs):
        r = procs.index(failed) if failed is not None else next(
            i for i, p in enumerate(procs) if p.returncode)
        raise RuntimeError(f"chip_smoke: {spec['label']} rank {r} failed "
                           f"(rc {procs[r].returncode}): "
                           f"{logs[r]}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(spec["dir"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out, secs


def _param_gaps(got, want) -> list:
    """Each leaf's max |got - want| over its max |want|, worst first."""
    return sorted(((float((got[k] - w).abs().max() / w.abs().max()),
                    "/".join(k)) for k, w in want.items()), reverse=True)


def phase_multirank(counts, runs=None, world=RANKS, threads=2,
                    phase=27) -> dict:
    """Phase 27 (``runs`` default ``MULTIRANK``): ``world`` ranks sharing
    this card over gloo train (a) GPT-345M's width at 1 of 24 layers,
    ``mp=2, sep=2``, 2 x 1024, the zigzag ring; (b) that width at 2
    layers, ``dp=2, sharding=2``, ZeRO 3, 4 x 1024; (c) LLaMA-7B's width at 1 of
    32 layers, ``sep=2, sharding=2``, ZeRO 3, 2 x 2048; each 2 fp32 steps
    held to a single-rank trainer on the card (losses and each step's
    grad norm 1e-4 relative, params 1e-4 of each leaf's largest); (d) (a)
    in bf16 for 5 steps.

    Phase 28 (``PIPELINE``): the same world over the ``"pipe"`` axis
    (the module docstring's sub-phases), the losses held to 1e-6
    relative, each rank's microbatches in flight to its schedule's law
    and (e)'s stage-0 peak below the same configuration's under GPipe
    (``e-gpipe``)."""
    runs = runs or (MULTIRANK if phase == 27 else PIPELINE)
    label = f"phase {phase}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if DEV.type == "cuda" else "cpu"
    what = ("multi-rank training" if phase == 27 else
            "pipeline parallelism over the \"pipe\" axis")
    log(f"[{phase}] {what}: backend gloo, world {world}, {world} ranks per "
        f"card ({DEV}), {smi}")
    t0 = time.perf_counter()
    derived = {}
    for name, (family, layers, layout, _, _, steps) in runs.items():
        # per rank of "sep" (the naive ring's blocks differ along it)
        derived[name] = [world_launches(layers, layout, steps, r)
                         for r in range(layout.get("sep", 1))]
        log(f"  ({name}) {family} {layers} layers {layout}: launches a rank "
            f"derived from the code, by rank of \"sep\": {derived[name]}")
    compare = [k for k, r in runs.items() if r[4] == "float32"]
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    spec = {"device": str(DEV), "threads": threads, "dir": work,
            "compare": compare, "runs": runs, "seed": phase, "label": label,
            "models": {"gpt": dataclasses.asdict(model_config()),
                       "llama": dataclasses.asdict(llama_config())}}
    started = None
    try:
        # the ranks start from the references' weights; the references
        # then run on the card beside the world
        for k in compare:
            if not os.path.exists(_init_path(work, *runs[k][:2])):
                multirank_trainer(runs[k], work)
        torch.cuda.empty_cache()
        started = start_world(spec, world)
        K.reset_launch_counts()
        by_key = {}
        for k in compare:       # sub-phases that share a reference run it once
            key = _reference_key(runs[k])
            if key not in by_key:
                by_key[key] = multirank_reference(runs[k], work, seed=phase)
        refs = {k: by_key[_reference_key(runs[k])] for k in compare}
        ref_launches = K.launch_counts()
        ranks, world_s = wait_world(started)
        got = {k: torch.load(os.path.join(work, f"params-{k}.pt"))
               for k in compare}
    finally:
        if started is not None:
            stop_world(started)
        shutil.rmtree(work, ignore_errors=True)
    log(f"  {ranks[0]['mesh']}")
    log(f"  collectives: {ranks[0]['collectives']}")
    ref_s = ", ".join(f"({k}) {r['s']:.1f}" for k, r in refs.items()
                      if k not in SAME_LOSSES)
    log(f"  references {ref_s} s; the world {world_s:.1f} s")
    # the single-rank references' launches stay out of ``counts`` (the
    # main path's): they are the comparison, not the ranks' run
    out = {"world": world, "ranks_per_card": world, "mesh": ranks[0]["mesh"],
           "collectives": ranks[0]["collectives"], "world_s": world_s,
           "reference_s": {k: r["s"] for k, r in refs.items()},
           "reference_launches": {k: v for k, v in ref_launches.items()
                                  if v}}
    fails = [f"rank {r} collectives: {rk['collectives']}"
             for r, rk in enumerate(ranks)
             if not all(rk["collectives"].values())]
    loss_tol = 1e-4 if phase == 27 else 1e-6
    for name, (family, layers, layout, (b, s), dtype, steps) in runs.items():
        per_rank = [rk[name] for rk in ranks]
        m = {"layout": layout, "batch": [b, s], "dtype": dtype,
             "losses": per_rank[0]["losses"],
             "gnorms": per_rank[0]["gnorms"],
             "launches_per_rank": [r["launches"] for r in per_rank],
             "derived_launches": derived[name][0],
             "live_state_bytes": [r["live_state_bytes"] for r in per_rank],
             "planned_bytes": per_rank[0]["planned_bytes"],
             "build_s": max(r["build_s"] for r in per_rank),
             "steps_s": max(sum(r["step_s"]) for r in per_rank),
             "step_s": [max(r["step_s"][i] for r in per_rank)
                        for i in range(steps)],
             "gather_save_s": max(r.get("gather_save_s", 0.0)
                                  for r in per_rank),
             "max_memory_allocated_gb": max(r["max_memory_allocated_gb"]
                                            for r in per_rank),
             "s": max(r["build_s"] + sum(r["step_s"])
                      + r.get("gather_save_s", 0.0) for r in per_rank)}
        if len(derived[name]) > 1 and derived[name][1] != derived[name][0]:
            m["derived_launches_by_sep_rank"] = derived[name]
        counts[f"phase{phase}_{name}"] = {
            k: sum(r["launches"].get(k, 0) for r in per_rank)
            for k in K.KERNELS}
        for r, pr in enumerate(per_rank):
            if pr["losses"] != m["losses"]:
                fails.append(f"({name}): rank {r}'s losses differ")
            want_l = derived[name][pr["sep_rank"]]
            got_l = {k: pr["launches"][k] for k in want_l}
            if got_l != want_l:
                fails.append(f"({name}) rank {r}: launches {got_l}, "
                             f"derived {want_l}")
            if pr["live_state_bytes"] != pr["planned_bytes"]:
                fails.append(f"({name}) rank {r}: live state "
                             f"{pr['live_state_bytes']} B, planned "
                             f"{pr['planned_bytes']} B")
        pp = layout.get("pp", 1)
        if pp > 1:
            fails += _pipeline_gates(name, layout, per_rank, m)
        if layout.get("sep", 1) > 1:
            shapes = {tuple(x[:4]) for r in per_rank for x in r["blocks"]}
            m["ring_blocks"] = sorted([list(x) for x in shapes])
            if _naive_ring(layout):
                c = s // layout["sep"]
                wants = [("K-PACK", c, c, True), ("K-PACK", c, c, False)]
            else:
                L = s // layout["sep"] // 2
                wants = [("K-PACK", L, 2 * L, False),
                         ("K-PACK", 2 * L, L, False),
                         ("K-PACK", L, L, False), ("K-PACK", L, L, True)]
            for want in wants:
                if want not in shapes:
                    fails.append(f"({name}): no {want} block in the ring")
        if layout.get("packed_sequences"):
            m.update(_packed_split(layout, phase, b, s,
                                   _model_of(family, 1).vocab_size))
            if len(set(m["real_labels_per_batch_shard"])) < 2:
                fails.append(f"({name}): every batch shard holds "
                             f"{m['real_labels_per_batch_shard'][0]} real "
                             "labels; the global mean is not tested")
        if name in refs:
            ref = refs[name]
            lg = max(abs(a - w) / abs(w) for a, w in
                     zip(m["losses"], ref["losses"]))
            gg = max(abs(a - w) / abs(w) for a, w in
                     zip(m["gnorms"], ref["gnorms"]))
            gaps = _param_gaps(got[name], ref["params"])
            m.update(loss_ref=ref["losses"], gnorm_ref=ref["gnorms"],
                     loss_gap=lg, gnorm_gap=gg, param_gap=gaps[0][0],
                     param_gap_leaf=gaps[0][1], param_gaps_worst=gaps[:5])
            if lg > loss_tol:
                fails.append(f"({name}) losses {m['losses']} vs one rank "
                             f"{ref['losses']}")
            if name in SAME_LOSSES and SAME_LOSSES[name] in out:
                ring = out[SAME_LOSSES[name]]["losses"]
                m["ring_loss_gap"] = max(abs(a - w) / abs(w) for a, w in
                                         zip(m["losses"], ring))
                if m["ring_loss_gap"] > 1e-5:
                    fails.append(f"({name}) losses {m['losses']} vs the "
                                 f"ring's ({SAME_LOSSES[name]}) {ring}")
            # the grad norm checks the cross-rank grad sums directly,
            # whatever Adam's eps does to the params
            if gg > 1e-4:
                fails.append(f"({name}) grad norms {m['gnorms']} vs one "
                             f"rank {ref['gnorms']}")
            if gaps[0][0] > 1e-4:
                fails.append(f"({name}) params: {gaps[0][1]} off by "
                             f"{gaps[0][0]:.3e} of its largest")
        else:
            med = float(np.median([max(r["step_s"][i] for r in per_rank)
                                   for i in range(1, steps)])) * 1e3
            m["step_ms"] = med
            m["tokens_per_s"] = b * s / (med / 1e3)
            real = ""
            if layout.get("packed_sequences"):
                m["real_tokens_per_s"] = (m["tokens_per_s"]
                                          * m["packing_efficiency"])
                real = f", {m['real_tokens_per_s']:.0f} real tokens/s"
            if not (m["losses"][-1] < m["losses"][0]
                    and all(np.isfinite(m["losses"]))):
                fails.append(f"({name}): losses {m['losses']}")
            log(f"  ({name}) step {med:.1f} ms median of steps 2-{steps}, "
                f"{m['tokens_per_s']:.0f} tokens/s{real} ({world} ranks on "
                f"one card: not a multi-card rate)")
        log(f"  ({name}) " + json.dumps(
            {k: v for k, v in m.items() if k != "launches_per_rank"}))
        out[name] = m
    if "e" in out and "e-gpipe" in out:
        ours, gpipe = (next(r["max_memory_allocated_gb"] for r in
                            (rk[k] for rk in ranks) if r["stage"] == 0)
                       for k in ("e", "e-gpipe"))
        out["e"]["stage0_peak_gb"] = {"1f1b": ours, "gpipe": gpipe}
        log(f"  (e) stage 0's peak: 1F1B {ours:.3f} GB, GPipe {gpipe:.3f} "
            f"GB")
        if DEV.type == "cuda" and not gpipe > ours:
            fails.append(f"(e) GPipe's stage-0 peak {gpipe:.3f} GB is not "
                         f"above 1F1B's {ours:.3f} GB")
    log("  sub-phase seconds (the slowest rank's build, steps and gather): "
        + json.dumps({k: round(out[k]["s"], 1) for k in runs}))
    require(not fails, f"{label}: " + "; ".join(fails))
    out["s"] = time.perf_counter() - t0
    log(f"  {out['s']:.1f} s")
    return out


def _packed_split(layout, seed, b, s, vocab) -> dict:
    """A packed sub-phase's batch as the mesh cuts it: the real labels
    (``packed_loss_mask``) each batch shard holds, and the rows' packing
    efficiency (real tokens over slots)."""
    from paddle_tpu_torch.parallel.transformer_core import packed_loss_mask

    (_, _, seg, _), eff = packed_rows(seed, b, s, *PACKED_DOCS, vocab)
    per_row = packed_loss_mask(torch.from_numpy(seg)).sum(1)
    nb = layout.get("dp", 1) * layout.get("sharding", 1)
    return {"real_labels_per_batch_shard":
            [int(x) for x in per_row.reshape(nb, -1).sum(1)],
            "packing_efficiency": eff}


def _pipeline_gates(name, layout, per_rank, m) -> list:
    """Phase 28's checks of one pipelined sub-phase: each rank's most
    microbatches in flight (1F1B ``min(pp - s, M)`` on stage s, GPipe
    M); records the stages, peaks, chunk bytes and the ideal bubble."""
    pp = layout["pp"]
    M = layout.get("micro_batches") or 2 * pp
    gpipe = layout.get("pp_schedule") == "gpipe"
    m.update(stages=[r["stage"] for r in per_rank],
             in_flight=[r["in_flight"] for r in per_rank],
             peak_gb=[r["max_memory_allocated_gb"] for r in per_rank],
             chunk_bytes_sent=[r["chunk_bytes_sent"] for r in per_rank],
             ideal_bubble=(pp - 1) / (M + pp - 1))
    fails = []
    if layout.get("vpp", 1) > 1:
        return fails
    for r, pr in enumerate(per_rank):
        want = M if gpipe else min(pp - pr["stage"], M)
        if pr["in_flight"] != want:
            fails.append(f"({name}) rank {r} (stage {pr['stage']}): "
                         f"{pr['in_flight']} microbatches in flight, the "
                         f"schedule holds {want}")
    return fails


# -- phase 29: BERT and varlen attention (full attention) ----------------------

def bert_config(kind, **kw):
    """BERT-base (``bert_base()``: hidden 768, 12 layers, 12 heads of 64,
    vocab 30522) or BERT-large (``bert_large()``: hidden 1024, 24 layers,
    16 heads), the published shapes (Devlin et al. 2019, Table 1 and
    Section 3); ``num_layers`` cuts the depth."""
    from paddle_tpu_torch.models.bert import bert_base, bert_large

    return dataclasses.replace(
        (bert_base if kind == "base" else bert_large)(), **kw)


def bert_batch(rng, b, s, cfg, lengths=None):
    """Random token and token-type ids, MLM labels and NSP labels, and
    with ``lengths`` a 0/1 padding mask whose row i keeps its first
    ``lengths[i]`` tokens (None: no mask)."""
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
    types = torch.from_numpy(rng.randint(0, 2, (b, s)))
    mlm_y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
    nsp_y = torch.from_numpy(rng.randint(0, 2, (b,)))
    mask = None if lengths is None else torch.from_numpy(
        (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int64))
    return ids, types, mlm_y, nsp_y, mask


def _bert_delta(before, kernels):
    """The launches of ``kernels`` since ``before`` (a ``launch_counts``),
    as ``{name: n}``."""
    now = K.launch_counts()
    return {n: now[n] - before[n] for n in kernels}


SEG3, BSHD3 = ("K-SEG", "K-SDQ", "K-SDKV"), ("K-BSHD", "K-BDQ", "K-BDKV")


def bert_vs_cpu(layers, shape, pad_to, what) -> dict:
    """(a): ``BertForPretraining`` at BERT-large's width, ``layers`` deep,
    fp32, the same weights (drawn on the CPU from seed 0) on the card and
    on the CPU, one ``shape`` batch (seed 29), padded (row 0 kept to
    ``pad_to`` tokens) and unpadded: MLM and NSP logits within 2e-3, the
    loss within 1e-4 and every grad within 1e-4 of its leaf's largest CPU
    grad; the padded run launches K-SEG, K-SDQ and K-SDKV once a layer,
    the unpadded one K-BSHD, K-BDQ and K-BDKV, all full attention."""
    from paddle_tpu_torch.models.bert import BertForPretraining

    cfg = bert_config("large", num_layers=layers, hidden_dropout=0.0,
                      attention_dropout=0.0)
    cpu = BertForPretraining(cfg, device="cpu").train()
    card = BertForPretraining(cfg, device=DEV).train()
    card.load_state_dict(cpu.state_dict())
    b, s = shape
    out = {}
    for padded in (True, False):
        rng = np.random.RandomState(29)
        lengths = [pad_to] + [s] * (b - 1) if padded else None
        ids, types, mlm_y, nsp_y, mask = bert_batch(rng, b, s, cfg, lengths)
        res = {}
        for side, m in (("card", card), ("cpu", cpu)):
            dev = next(m.parameters()).device
            m.zero_grad(set_to_none=True)
            before = K.launch_counts()
            mlm, nsp = m(ids.to(dev), types.to(dev),
                         None if mask is None else mask.to(dev))
            loss = m.loss(mlm, nsp, mlm_y.to(dev), nsp_y.to(dev),
                          None if mask is None else mask.to(dev))
            loss.backward()
            torch.cuda.synchronize()
            res[side] = dict(
                mlm=mlm.detach().cpu(), nsp=nsp.detach().cpu(),
                loss=float(loss.detach()),
                grads={n: p.grad.cpu() for n, p in m.named_parameters()},
                launches=_bert_delta(before, SEG3 + BSHD3))
        c, h = res["card"], res["cpu"]
        worst, leaf = worst_grad(c["grads"], h["grads"])
        tag = "padded" if padded else "unpadded"
        r = {"mlm_err": max_err(c["mlm"], h["mlm"]),
             "nsp_err": max_err(c["nsp"], h["nsp"]),
             "loss_card": c["loss"], "loss_cpu": h["loss"],
             "grad_worst_ratio": worst, "grad_worst_leaf": leaf,
             "launches": c["launches"]}
        log(f"  (a) {what}, {tag}: {json.dumps(r)}")
        require(r["mlm_err"] <= 2e-3 and r["nsp_err"] <= 2e-3,
                f"(a) {tag} logits: card vs CPU")
        require(abs(r["loss_card"] - r["loss_cpu"]) <= 1e-4,
                f"(a) {tag} loss: card vs CPU")
        require(worst <= 1e-4, f"(a) {tag} grads of {leaf}: card vs CPU")
        on, off = (SEG3, BSHD3) if padded else (BSHD3, SEG3)
        want = {**dict.fromkeys(on, layers), **dict.fromkeys(off, 0)}
        require(c["launches"] == want, f"(a) {tag} launches "
                f"{c['launches']}, expected {want}")
        out[tag] = r
    return out


def bert_bench_step(steps, shape, peaks) -> dict:
    """(b): ``bench_all.py``'s BERT step as the JAX package defines it
    (``bench_bert_base``): BERT-base at full depth, fp32 params, ``shape``
    random ids and MLM labels (seed 0), the mean MLM cross entropy
    (logsumexp - gold over every position), momentum SGD (lr 0.01,
    momentum 0.9: ``torch.optim.SGD``, the same update), hidden and
    attention dropout 0.1 (the config's defaults, the attention's inside
    the kernels). One warm-up step, then ``steps`` steps timed with one
    synchronisation: step ms, tokens/s and MFU by the bench's count
    (``6 * 110e6 + 12 * 12 * 768 * seq`` FLOPs a token) against the fp32
    peak; the loss falls, and each step launches K-BSHD, K-BDQ and K-BDKV
    once a layer, each its DROP variant."""
    from paddle_tpu_torch.models.bert import BertForPretraining

    cfg = bert_config("base")
    model = BertForPretraining(cfg, device=DEV).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    rs = np.random.RandomState(0)
    b, s = shape
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    mlm_y = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).to(DEV)

    def step():
        mlm, _ = model(ids)
        logits = mlm.float()
        gold = logits.gather(-1, mlm_y[..., None])[..., 0]
        loss = (torch.logsumexp(logits, -1) - gold).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    first = step()
    torch.cuda.synchronize()
    before = K.launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bert_delta(before, BSHD3 + SEG3)
    losses = [float(first)] + [float(x) for x in losses]
    tok_s = b * s * steps / wall
    flops_tok = 6 * 110e6 + 12 * 12 * 768 * s
    m = {"batch": b, "seq": s, "steps": steps, "step_ms": wall / steps * 1e3,
         "tokens_per_s": tok_s, "mfu_fp32": tok_s * flops_tok / peaks["fp32"],
         "flops_per_token": flops_tok, "losses": losses,
         "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
         "launches": launches}
    log(f"  (b) bench_all.py's BERT-base step: {json.dumps(m)}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "(b) BERT-base losses not finite and falling")
    n = cfg.num_layers * steps
    require(launches == {**dict.fromkeys(BSHD3, n), **dict.fromkeys(SEG3, 0)},
            f"(b) launches {launches}, expected {n} of each BSHD kernel")
    del model, opt
    return m


def bert_large_train(steps, shape) -> dict:
    """(c): BERT-large at full depth, bf16 params and
    ``torch.optim.AdamW`` (lr 1e-4) as phase 12 trains, a ``shape`` batch
    padded to phase 2's key lengths (``bert_key_lengths``, seed 29), MLM
    loss over the real tokens plus NSP, dropout 0.1 on the hidden states
    and in the attention (the config's defaults). One warm-up step, then
    ``steps`` timed: step ms, tokens/s, real tokens/s, peak memory; losses
    finite, and each step launches K-SEG, K-SDQ and K-SDKV once a layer,
    each its DROP variant."""
    from paddle_tpu_torch.models.bert import BertForPretraining

    cfg = bert_config("large")
    model = BertForPretraining(cfg, device=DEV, dtype=torch.bfloat16).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    b, s = shape
    lengths = bert_key_lengths(b, s)
    ids, types, mlm_y, nsp_y, mask = (
        x.to(DEV) for x in bert_batch(np.random.RandomState(29), b, s, cfg,
                                      lengths))

    def step():
        mlm, nsp = model(ids, types, mask)
        loss = model.loss(mlm.float(), nsp.float(), mlm_y, nsp_y, mask)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    first = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = K.launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bert_delta(before, SEG3 + BSHD3)
    losses = [float(first)] + [float(x) for x in losses]
    real = int(np.sum(lengths))
    m = {"batch": b, "seq": s, "steps": steps, "real_tokens": real,
         "step_ms": wall / steps * 1e3,
         "tokens_per_s": b * s * steps / wall,
         "real_tokens_per_s": real * steps / wall, "losses": losses,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": launches}
    log(f"  (c) BERT-large bf16, padded: {json.dumps(m)}")
    require(all(np.isfinite(losses)), "(c) non-finite BERT-large loss")
    n = cfg.num_layers * steps
    require(launches == {**dict.fromkeys(SEG3, n), **dict.fromkeys(BSHD3, 0)},
            f"(c) launches {launches}, expected {n} of each SEG kernel")
    del model, opt
    return m


def varlen_vs_plain(nseq, tq, tk, nh, d) -> dict:
    """(d): ``nn.functional.flash_attn_unpadded`` on the card, fp32,
    ``nseq`` sequences over ``tq`` queries and ``tk`` keys (distinct
    ``cu_seqlens``, seeds 30 and 31; phase 2's varlen row), non-causal:
    the output and the grads of q, k, v through autograd against the
    same call on CPU tensors (the plain versions), ``hold``'s fp32
    tolerance; one K-SEG, K-SDQ and K-SDKV launch. Then the causal call
    with distinct ``cu_seqlens``, which no kernel computes, raises on the
    card."""
    from paddle_tpu_torch.nn import functional as NF

    cu_q, cu_k = varlen_cu(nseq, tq, 30), varlen_cu(nseq, tk, 31)
    rng = np.random.RandomState(29)
    q, k, v = (torch.from_numpy(rng.randn(n, nh, d).astype(np.float32))
               for n in (tq, tk, tk))
    do = torch.from_numpy(rng.randn(tq, nh, d).astype(np.float32))
    res = {}
    for side, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        ts = [x.to(dev).requires_grad_() for x in (q, k, v)]
        before = K.launch_counts()
        o, _ = NF.flash_attn_unpadded(*ts, torch.from_numpy(cu_q).to(dev),
                                      torch.from_numpy(cu_k).to(dev),
                                      int(np.diff(cu_q).max()),
                                      int(np.diff(cu_k).max()), d ** -0.5)
        o.backward(do.to(dev))
        torch.cuda.synchronize()
        res[side] = ([o.detach().cpu()] + [t.grad.cpu() for t in ts],
                     _bert_delta(before, SEG3 + BSHD3))
    (card, launches), (cpu, _) = res["card"], res["cpu"]
    out = hold((("flash_attn_unpadded", tuple(zip(card, cpu))),),
               torch.float32, f"total_q={tq} total_k={tk} {nseq} sequences "
               f"nh={nh} d={d} full, output and dq, dk, dv")
    require(launches == {**dict.fromkeys(SEG3, 1), **dict.fromkeys(BSHD3, 0)},
            f"(d) launches {launches}, expected 1 of each SEG kernel")
    if DEV.type == "cuda":
        cq, ck = (torch.from_numpy(c).to(DEV) for c in (cu_q, cu_k))
        try:
            NF.flash_attn_unpadded(q.to(DEV), k.to(DEV), v.to(DEV), cq, ck,
                                   1, 1, d ** -0.5, causal=True)
        except NotImplementedError as e:
            log(f"  (d) causal with distinct cu_seqlens raises: {e}")
        else:
            raise RuntimeError("chip_smoke: (d) causal varlen attention "
                               "with distinct cu_seqlens ran on the card")
    return {"max_abs_err": out["flash_attn_unpadded"]["max_abs_err"],
            "launches": launches}


def phase_bert(counts, peaks, acc_layers=2, acc_shape=(2, 512), pad_to=200,
               bench_shape=(128, 128), bench_steps=8, large_shape=(16, 512),
               large_steps=3, varlen=(8, 2048, 3072, 16, 64)) -> dict:
    """Phase 29: BERT pretraining and encoding on full attention, and
    varlen attention: (a) ``bert_vs_cpu``, (b) ``bert_bench_step``, (c)
    ``bert_large_train``, (d) ``varlen_vs_plain``; the counts are set to 0
    before (a) and read after (d)."""
    log(f"[29] BERT and varlen attention: (a) BERT-large width, "
        f"{acc_layers} layers, fp32 {acc_shape[0]} x {acc_shape[1]} card vs "
        f"CPU; (b) bench_all.py's BERT-base step {bench_shape[0]} x "
        f"{bench_shape[1]}; (c) BERT-large bf16 {large_shape[0]} x "
        f"{large_shape[1]} padded; (d) flash_attn_unpadded")
    t0 = time.perf_counter()
    K.reset_launch_counts()
    m = {"a": bert_vs_cpu(acc_layers, acc_shape, pad_to,
                          f"BERT-large width, {acc_layers} layers")}
    gc.collect()
    torch.cuda.empty_cache()
    m["b"] = bert_bench_step(bench_steps, bench_shape, peaks)
    torch.cuda.empty_cache()
    m["c"] = bert_large_train(large_steps, large_shape)
    torch.cuda.empty_cache()
    m["d"] = varlen_vs_plain(*varlen)
    counts["phase29"] = {**K.launch_counts(), **K.variant_counts()}
    m["seconds"] = time.perf_counter() - t0
    log(f"  phase 29: {m['seconds']:.1f} s; launches {counts['phase29']}")
    return m



# -- phase 32: the transformer layers at Transformer-base width -------------

# ``paddle.nn.Transformer()`` at its defaults, Transformer-base (Vaswani et
# al. 2017, Table 3): d_model 512, 8 heads of 64, 6 + 6 layers, FFN 2048,
# dropout 0.1; (b) over a shared vocabulary of 37,000 (the paper's WMT
# 2014 English-German byte-pair vocabulary)
TRANSFORMER_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
                        num_decoder_layers=6, dim_feedforward=2048,
                        dropout=0.1)
TRANSFORMER_VOCAB = 37000


def variant_delta(before) -> dict:
    """The variants' launches since ``before`` (a ``variant_counts``),
    those with any."""
    return {n: c - before.get(n, 0) for n, c in K.variant_counts().items()
            if c != before.get(n, 0)}


def pair_batch(seed, b, s_src, s_tgt, lo, hi, vocab):
    """``b`` sentence pairs of random token ids (1 to vocab - 1), source
    and target real lengths uniform in [lo, hi] (numpy seed ``seed``), pad
    id 0 after them: ``(src, tgt, src_len, tgt_len)``."""
    rng = np.random.RandomState(seed)
    src_len = rng.randint(lo, min(hi, s_src) + 1, b)
    tgt_len = rng.randint(lo, min(hi, s_tgt) + 1, b)
    src = rng.randint(1, vocab, (b, s_src))
    tgt = rng.randint(1, vocab, (b, s_tgt))
    src[np.arange(s_src)[None] >= src_len[:, None]] = 0
    tgt[np.arange(s_tgt)[None] >= tgt_len[:, None]] = 0
    return (torch.from_numpy(src), torch.from_numpy(tgt), src_len, tgt_len)


def src_padding_mask(src_len, s, dev):
    """The source padding mask on ``dev``: ``(B, 1, 1, S)`` fp32, -1e9 on
    the keys past each row's length (the encoder's ``src_mask`` and the
    decoder's ``memory_mask``)."""
    pos = torch.arange(s, device=dev)[None]
    lens = torch.as_tensor(np.asarray(src_len), device=dev)[:, None]
    return torch.where(pos < lens, 0.0, -1e9)[:, None, None, :]


def sinusoid(s, d, dev, dtype):
    """The paper's fixed positional encodings, ``(S, d)``."""
    pos = torch.arange(s, dtype=torch.float64)[:, None]
    inv = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    pe = torch.zeros(s, d, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * inv), torch.cos(pos * inv)
    return pe.to(dev, dtype)


# a leaf whose largest CPU grad is at most this share of the largest of
# any leaf holds rounding only (``worst_grad``)
GRAD_ROUNDING = 1e-5


def transformer_vs_cpu(layers=1, b=2, s_src=96, s_tgt=80, seed=32) -> dict:
    """(a): ``nn.Transformer`` at Transformer-base width, ``layers`` +
    ``layers`` deep, fp32, the same weights on the card and on the CPU,
    attention dropout 0.1 from one key (``rng_context``: every call's
    Philox key is the same on both sides, hence the same bits) and hidden
    dropout 0 (PyTorch's CPU and CUDA RNGs differ), the source padding
    masks and the causal target mask made on the card (copied to the CPU
    for its side): the decoder's output within 2e-3, a squared-error loss
    within 1e-4 and every grad within 1e-4 of its leaf's largest CPU
    grad (a leaf whose CPU grad is at most 1e-5 of the largest of any
    leaf, such as a key projection's bias, whose true grad is 0, within
    1e-4 of that largest: ``worst_grad``'s ``rounding``); each attention
    call
    one launch of K-BSHD, K-BDQ and K-BDKV, all with a mask and
    dropout."""
    from paddle_tpu_torch.framework.random import rng_context
    from paddle_tpu_torch.nn import Transformer

    kw = {**TRANSFORMER_BASE, "num_encoder_layers": layers,
          "num_decoder_layers": layers, "dropout": 0.0, "attn_dropout": 0.1}
    torch.manual_seed(seed)
    card = Transformer(device=DEV, **kw).train()
    cpu = Transformer(device="cpu", **kw).train()
    cpu.load_state_dict(card.state_dict())
    rng = np.random.RandomState(seed)
    d = kw["d_model"]
    src, tgt, target = (torch.from_numpy(rng.randn(b, n, d).astype(
        np.float32)) for n in (s_src, s_tgt, s_tgt))
    src_mask = src_padding_mask([s_src, s_src * 2 // 3], s_src, DEV)
    tgt_mask = Transformer.generate_square_subsequent_mask(s_tgt, device=DEV)
    res = {}
    for side, m in (("card", card), ("cpu", cpu)):
        dev = next(m.parameters()).device
        before, vbefore = K.launch_counts(), K.variant_counts()
        with rng_context((seed, 16)):
            out = m(src.to(dev), tgt.to(dev), src_mask.to(dev),
                    tgt_mask.to(dev), src_mask.to(dev))
        loss = ((out - target.to(dev)) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
        res[side] = dict(
            out=out.detach().cpu(), loss=float(loss.detach()),
            grads={n: p.grad.cpu() for n, p in m.named_parameters()},
            launches={n: c - before[n] for n, c in K.launch_counts().items()
                      if n in BSHD3},
            variants=variant_delta(vbefore))
    c, h = res["card"], res["cpu"]
    # a key projection's bias shifts every score of a query's row by the
    # same q.b_k, which the softmax cancels: its true grad is exactly 0,
    # and both sides hold rounding only
    top = max(float(g.abs().max()) for g in h["grads"].values())
    zero = sorted(n for n, g in h["grads"].items()
                  if float(g.abs().max()) <= GRAD_ROUNDING * top)
    worst, leaf = worst_grad(c["grads"], h["grads"], GRAD_ROUNDING)
    calls = 3 * layers
    r = {"out_err": max_err(c["out"], h["out"]), "loss_card": c["loss"],
         "loss_cpu": h["loss"], "grad_worst_ratio": worst,
         "grad_worst_leaf": leaf, "rounding_leaves": zero,
         "launches": c["launches"], "variants": c["variants"]}
    log(f"  (a) Transformer-base width, {layers} + {layers} layers, fp32, "
        f"attention dropout 0.1: {json.dumps(r)}")
    require(r["out_err"] <= 2e-3, "(a) Transformer output: card vs CPU")
    require(abs(r["loss_card"] - r["loss_cpu"]) <= 1e-4,
            "(a) Transformer loss: card vs CPU")
    require(worst <= 1e-4, f"(a) Transformer grads of {leaf}: card vs CPU")
    want = {f"{n}+bias+drop": calls for n in BSHD3}
    require(r["launches"] == dict.fromkeys(BSHD3, calls)
            and r["variants"] == want,
            f"(a) launches {r['launches']} {r['variants']}, expected "
            f"{calls} of each kernel's +bias+drop")
    del card, cpu
    return r


def transformer_base_train(steps=20, b=32, s=256, lo=32, seed=32,
                           lr=3e-4) -> dict:
    """(b): Transformer-base at full depth in bf16, dropout 0.1 everywhere
    (the attention's inside the kernels), ``b`` sentence pairs padded to
    ``s`` / ``s`` (real lengths ``lo`` to ``s``, seed 32) over a shared
    vocabulary of ``TRANSFORMER_VOCAB``; the harness embeds them (one
    embedding scaled by sqrt(d_model) plus the sinusoids) and projects
    the decoder's output onto the same embedding (tied), cross entropy on
    the next target token over the real ones; ``torch.optim.AdamW``.
    One warm-up step, then ``steps`` timed: step ms, tokens/s, real
    tokens/s, peak memory; the loss falls, and each step launches K-BSHD,
    K-BDQ and K-BDKV 18 times (6 encoder self-attentions, 6 decoder
    self-attentions, 6 cross-attentions), each with a mask and
    dropout."""
    from paddle_tpu_torch.nn import Transformer

    bf = torch.bfloat16
    torch.manual_seed(seed)
    model = Transformer(device=DEV, dtype=bf, **TRANSFORMER_BASE).train()
    d = TRANSFORMER_BASE["d_model"]
    emb = torch.nn.Parameter(torch.randn(TRANSFORMER_VOCAB, d, device=DEV,
                                         dtype=bf) * d ** -0.5)
    opt = torch.optim.AdamW([*model.parameters(), emb], lr=lr)
    src, tgt, src_len, tgt_len = (
        x.to(DEV) if torch.is_tensor(x) else x
        for x in pair_batch(seed, b, s, s, min(lo, s), s,
                            TRANSFORMER_VOCAB))
    src_mask = src_padding_mask(src_len, s, DEV)
    tgt_mask = Transformer.generate_square_subsequent_mask(s, device=DEV)
    pe = sinusoid(s, d, DEV, bf)
    # decoder input: the target shifted right behind a start id (0); the
    # label at each real position is that position's token
    dec_in = torch.cat([torch.zeros_like(tgt[:, :1]), tgt[:, :-1]], 1)
    labels = tgt.masked_fill(tgt == 0, -100)
    drop = torch.nn.Dropout(TRANSFORMER_BASE["dropout"])

    def embed(ids):
        return drop(torch.nn.functional.embedding(ids, emb) * d ** 0.5 + pe)

    def step():
        out = model(embed(src), embed(dec_in), src_mask, tgt_mask, src_mask)
        logits = (out @ emb.T).float()
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, TRANSFORMER_VOCAB), labels.reshape(-1))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    first = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, vbefore = K.launch_counts(), K.variant_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: K.launch_counts()[n] - before[n] for n in BSHD3}
    variants = variant_delta(vbefore)
    losses = [float(first)] + [float(x) for x in losses]
    real = int(np.sum(src_len) + np.sum(tgt_len))
    m = {"batch": b, "src": s, "tgt": s, "steps": steps,
         "real_tokens": real, "step_ms": wall / steps * 1e3,
         "tokens_per_s": 2 * b * s * steps / wall,
         "real_tokens_per_s": real * steps / wall, "losses": losses,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": launches, "variants": variants}
    log(f"  (b) Transformer-base, 6 + 6 layers, bf16, dropout 0.1: "
        f"{json.dumps(m)}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "(b) Transformer-base losses not finite and falling")
    n = 18 * steps
    require(launches == dict.fromkeys(BSHD3, n)
            and variants == {f"{k}+bias+drop": n for k in BSHD3},
            f"(b) launches {launches} {variants}, expected {n} of each "
            "kernel's +bias+drop")
    del model, opt, emb
    return m


def gpt_default_dropout_train(steps=3, shape=(4, 1024)) -> dict:
    """(c) GPT-345M through the nn API at its default dropouts (hidden
    and attention 0.1), bf16, ``torch.optim.AdamW`` as phase 12 trains:
    one warm-up step, then ``steps`` timed; finite losses, and each step
    launches K-BSHD, K-BDQ and K-BDKV once a layer, each its DROP
    variant."""
    cfg = gpt_345m()
    model = GPTForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0)).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    crit = GPTPretrainingCriterion()
    ids, labels = (torch.from_numpy(x).to(DEV) for x in train_batch(
        np.random.RandomState(32), *shape, cfg.vocab_size))

    def step():
        loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    first = step()
    torch.cuda.synchronize()
    before, vbefore = K.launch_counts(), K.variant_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: K.launch_counts()[n] - before[n] for n in BSHD3}
    variants = variant_delta(vbefore)
    losses = [float(first)] + [float(x) for x in losses]
    m = {"batch": shape[0], "seq": shape[1], "step_ms": wall / steps * 1e3,
         "tokens_per_s": shape[0] * shape[1] * steps / wall,
         "losses": losses, "launches": launches, "variants": variants,
         "hidden_dropout": cfg.hidden_dropout,
         "attention_dropout": cfg.attention_dropout}
    log(f"  (c) GPT-345M, default dropouts, bf16: {json.dumps(m)}")
    n = cfg.num_layers * steps
    require(all(np.isfinite(losses)), "(c) GPT-345M losses not finite")
    require(launches == dict.fromkeys(BSHD3, n)
            and variants == {f"{k}+drop": n for k in BSHD3},
            f"(c) launches {launches} {variants}, expected {n} of each "
            "kernel's +drop")
    del model, opt
    return m


def bert_empty_row(layers=2, shape=(2, 128)) -> dict:
    """(c) BERT's padding row with no real token: ``BertForPretraining``
    at BERT-base width, ``layers`` deep, fp32, dropouts 0, the same
    weights on the card and the CPU, row 1 of the 0/1 mask all zero: the
    model takes the JAX model's additive mask for the batch (K-BSHD's,
    K-BDQ's and K-BDKV's BIAS variants, once a layer each), MLM and NSP
    logits within 2e-3 of the CPU's, the loss within 1e-4 and every grad
    within 1e-4 of its leaf's largest CPU grad."""
    from paddle_tpu_torch.models.bert import BertForPretraining

    cfg = bert_config("base", num_layers=layers, hidden_dropout=0.0,
                      attention_dropout=0.0)
    cpu = BertForPretraining(cfg, device="cpu").train()
    card = BertForPretraining(cfg, device=DEV).train()
    card.load_state_dict(cpu.state_dict())
    b, s = shape
    batch = bert_batch(np.random.RandomState(32), b, s, cfg,
                       [s // 2] + [0] * (b - 1))
    res = {}
    for side, m in (("card", card), ("cpu", cpu)):
        dev = next(m.parameters()).device
        ids, types, mlm_y, nsp_y, mask = (x.to(dev) for x in batch)
        vbefore = K.variant_counts()
        mlm, nsp = m(ids, types, mask)
        loss = m.loss(mlm, nsp, mlm_y, nsp_y)
        loss.backward()
        torch.cuda.synchronize()
        res[side] = dict(mlm=mlm.detach().cpu(), nsp=nsp.detach().cpu(),
                         loss=float(loss.detach()),
                         grads={n: p.grad.cpu()
                                for n, p in m.named_parameters()},
                         variants=variant_delta(vbefore))
    c, h = res["card"], res["cpu"]
    worst, leaf = worst_grad(c["grads"], h["grads"])
    r = {"mlm_err": max_err(c["mlm"], h["mlm"]),
         "nsp_err": max_err(c["nsp"], h["nsp"]), "loss_card": c["loss"],
         "loss_cpu": h["loss"], "grad_worst_ratio": worst,
         "grad_worst_leaf": leaf, "variants": c["variants"]}
    log(f"  (c) BERT-base width, {layers} layers, a row with no real token: "
        f"{json.dumps(r)}")
    require(r["mlm_err"] <= 2e-3 and r["nsp_err"] <= 2e-3,
            "(c) BERT empty row logits: card vs CPU")
    require(abs(r["loss_card"] - r["loss_cpu"]) <= 1e-4,
            "(c) BERT empty row loss: card vs CPU")
    require(worst <= 1e-4, f"(c) BERT empty row grads of {leaf}: card vs "
            "CPU")
    require(r["variants"] == {f"{n}+bias": layers for n in BSHD3},
            f"(c) BERT empty row launched {r['variants']}")
    del card, cpu
    return r


def phase_transformer(counts, acc_shape=(2, 96, 80), train_shape=(32, 256),
                      steps=20, gpt_shape=(4, 1024),
                      bert_shape=(2, 128)) -> dict:
    """Phase 32: (a) ``transformer_vs_cpu`` (batch, src, tgt
    ``acc_shape``), (b) ``transformer_base_train`` (pairs, length
    ``train_shape``), (c) ``gpt_default_dropout_train`` and
    ``bert_empty_row``; the counts are set to 0 before (a) and read after
    (c)."""
    log(f"[32] transformer layers: (a) Transformer-base width 1 + 1 layers "
        f"fp32 card vs CPU, attention dropout 0.1; (b) Transformer-base "
        f"6 + 6 bf16, {train_shape[0]} pairs of {train_shape[1]} / "
        f"{train_shape[1]}, {steps} AdamW steps; (c) GPT-345M and BERT at "
        f"their default dropouts, BERT's empty row")
    t0 = time.perf_counter()
    K.reset_launch_counts()
    b, s_src, s_tgt = acc_shape
    m = {"a": transformer_vs_cpu(b=b, s_src=s_src, s_tgt=s_tgt)}
    gc.collect()
    torch.cuda.empty_cache()
    m["b"] = transformer_base_train(steps, *train_shape)
    gc.collect()
    torch.cuda.empty_cache()
    m["c"] = {"gpt": gpt_default_dropout_train(shape=gpt_shape),
              "bert": bert_empty_row(shape=bert_shape)}
    counts["phase32"] = {**K.launch_counts(), **K.variant_counts()}
    gc.collect()
    torch.cuda.empty_cache()
    m["seconds"] = time.perf_counter() - t0
    log(f"  phase 32: {m['seconds']:.1f} s; launches {counts['phase32']}")
    return m


# -- phase 30: launched, durable multi-rank training --------------------------
#
# Ranks started by the port's launcher (``python -m
# paddle_tpu_torch.distributed.launch ... chip_smoke.py --launch-worker
# SPEC``), 4 of them sharing this card over gloo (the backend rule of
# ``init_parallel_env``), as phase 27's world. Each rank writes
# ``gen<G>-rank<R>.json`` after every step, so a killed rank's record
# survives it.

# the world's trainer: GPT-345M width at ``layers``, fp32, batch (B, S)
LAUNCH = {"layers": 2, "world": 4, "batch": (2, 1024), "steps": 7,
          "layout": dict(mp=2, sharding=2, zero_stage=3), "save_every": 2,
          "preempt_at": 3, "kill_at": 6, "kill_rank": 2}
# (c): 2 ranks at dp=2, the consistency check every 2 steps
DESYNC = {"world": 2, "layout": dict(dp=2), "every": 2, "desync_at": 3,
          "steps": 4}


def _atomic_json(path, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _ckpt_bytes(step_dir, rank) -> int:
    """The bytes one rank wrote into a checkpoint step."""
    mine = {f"shard-{rank}.pkl", f"manifest-{rank}.json"}
    if rank == 0:
        mine.add("meta.json")
    return sum(os.path.getsize(os.path.join(step_dir, f))
               for f in os.listdir(step_dir) if f in mine)


def launch_worker(spec_json: str) -> int:
    """``chip_smoke.py --launch-worker SPEC``: one rank of phase 30,
    started by the port's launcher. It joins the world through
    ``init_parallel_env``, trains ``spec["steps"]`` steps of the spec's
    GPT (batch i from seed ``spec["seed"] + i`` on every rank) and, with
    a checkpoint root, arms the preemption guard there, resumes from it
    and saves asynchronously every ``save_every`` steps; the fault points
    are the launcher's (``PADDLE_FI_*``). It records each step's loss,
    its launches and the checkpoint timings, and (rank 0) the gathered
    params at ``params_at`` to ``params-<label>.pt``; with ``probe``
    (the reference), :func:`guard_probe` after the last step. Exits 119
    on a desync, 118 when preempted."""
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.consistency import DesyncError
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.utils import fault_injection as fi

    spec = json.loads(spec_json)
    ts = {"enter": time.time()}
    torch.set_num_threads(1)
    dev = init_parallel_env(device="cpu" if spec["device"] == "cpu"
                            else None)
    ts["world"] = time.time()
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    gen = int(os.environ["PADDLE_RESTART_GENERATION"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load_library()      # built by phase 1; the lock if not
    else:
        _count_plain_versions()
    ts["lib"] = time.time()
    mcfg = GPTConfig(**spec["model"])
    tcfg = multirank_config("float32", consistency_check_every=spec["every"],
                            **spec["layout"])
    mesh = build_mesh(dp=tcfg.dp, pp=tcfg.pp, sharding=tcfg.sharding,
                      mp=tcfg.mp, sep=tcfg.sep, device=dev)
    ts["mesh"] = time.time()
    t = hybrid.HybridParallelTrainer(mcfg, tcfg, device=dev, mesh=mesh)
    ts["trainer"] = time.time()
    loader = DrillLoader(spec["seed"], *spec["batch"], mcfg.vocab_size)
    root = spec["root"]
    out = {"rank": rank, "gen": gen, "losses": {}, "launches": {},
           "snapshot_ms": [], "commit_ms": [], "resumed_at": 0,
           "ts": ts, "step_s": []}
    path = os.path.join(spec["dir"], f"{spec['label']}-gen{gen}-rank{rank}"
                                     ".json")
    mgr = None
    if root:
        t.enable_preemption_guard(root, dataloader=loader)
        if rank == 0:
            # what a resume must take: the newest step every rank completed
            out["verified"] = [s for s in ckpt.CheckpointManager(
                root).steps() if ckpt.verify_checkpoint(
                    os.path.join(root, f"step-{s}"))[0]]
        _sync(dev)
        t0 = time.perf_counter()
        out["resumed_at"] = t.load_checkpoint(root, dataloader=loader) or 0
        _sync(dev)
        out["load_ms"] = (time.perf_counter() - t0) * 1e3
    K.reset_launch_counts()
    out["first_step_ts"] = ts["first_step"] = time.time()
    while t.global_step < spec["steps"]:
        step = t.global_step + 1
        t0 = time.perf_counter()
        try:
            loss = float(t.step(*loader.next()))
        except hybrid.TrainingPreempted as e:
            out["losses"][str(step)] = float(e.loss)
            out.update(preempted_at=step, launches=K.launch_counts(),
                       last_ts=time.time())
            _atomic_json(path, out)
            raise
        except DesyncError as e:
            out["desync"] = {"step": t.global_step, "error": str(e)}
            _atomic_json(path, out)
            return hybrid.DESYNC_EXIT_CODE
        out["losses"][str(step)] = loss
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"] = K.launch_counts()
        if root and step % spec["save_every"] == 0:
            if mgr is not None:
                mgr.wait()
                out["commit_ms"].append(mgr.last_commit_s * 1e3)
            _sync(dev)
            t0 = time.perf_counter()
            t.save_checkpoint(root, step, dataloader=loader,
                              async_save=True)
            out["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
            mgr = t._async_mgrs[root]
        if step == spec.get("params_at"):
            full = t.full_params()
            if rank == 0:
                torch.save(dict(flatten(full)), os.path.join(
                    spec["dir"], f"params-{spec['label']}.pt"))
        out["last_ts"] = time.time()    # a SIGKILL comes right after
        _atomic_json(path, out)
        fi.at_step(step)
    if mgr is not None:
        t.flush_checkpoints()
        out["commit_ms"].append(mgr.last_commit_s * 1e3)
        last = max(ckpt.CheckpointManager(root).steps())
        out["ckpt_bytes"] = _ckpt_bytes(os.path.join(root, f"step-{last}"),
                                        rank)
    if spec.get("probe"):
        out["probe"] = guard_probe(t, loader, dev)
    _atomic_json(path, out)
    return 0


def guard_probe(t, loader, dev, steps=2) -> dict:
    """What the preemption guard and the collective spans cost a step
    over the mesh: ms a step with the guard disarmed and armed (its
    notice all-reduced and read on the host at every boundary), in the
    order off, on, on, off (a steady drift of the card's load cancels),
    ``steps`` steps each with no host read between them; the host us of
    one ``collective_span`` and the spans a step. Every rank runs it at
    the same steps."""
    from paddle_tpu_torch.distributed import collective_runtime as cr

    root = tempfile.mkdtemp(prefix="guard_probe_")   # no notice: unused
    ms = {"off": [], "on": []}
    seq0 = cr.flight_recorder()._seq
    for arm in ("off", "on", "on", "off"):
        if arm == "on":
            t.enable_preemption_guard(root)
        else:
            t._preempt_guard = None     # disarm: no API does it
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            t.step(*loader.next())
        _sync(dev)
        ms[arm].append(round((time.perf_counter() - t0) * 1e3 / steps, 2))
    t._preempt_guard = None
    spans = (cr.flight_recorder()._seq - seq0) / (4 * steps)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with cr.collective_span("probe"):
            pass
    span_us = (time.perf_counter() - t0) * 1e6 / n
    shutil.rmtree(root, ignore_errors=True)
    return {"step_ms": ms, "spans_a_step": spans,
            "span_us": round(span_us, 2)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_start(label, spec, world, work, args=(), env=None) -> dict:
    """Start one run of ``spec`` through the port's launcher, ``world``
    ranks (their logs under ``work/logs-<label>``, the launcher's stderr
    in ``work/launcher-<label>.err``); :func:`launch_finish` waits."""
    logs = os.path.join(work, f"logs-{label}")
    root = os.path.dirname(os.path.abspath(__file__))
    spec = dict(spec, label=label)
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith("PADDLE_")}
    full_env.update(OMP_NUM_THREADS="1",
                    PYTHONPATH=root + os.pathsep + os.environ.get(
                        "PYTHONPATH", ""),
                    PADDLE_FI_DIR=os.path.join(work, f"fi-{label}"),
                    **(env or {}))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(world), "--log_dir", logs,
           "--grace_secs", "10", "--restart_backoff", "0.1", *args,
           os.path.abspath(__file__), "--launch-worker", json.dumps(spec)]
    err = open(os.path.join(work, f"launcher-{label}.err"), "w+")
    return {"label": label, "world": world, "work": work, "logs": logs,
            "err": err, "t0": time.perf_counter(),
            "proc": subprocess.Popen(cmd, env=full_env, cwd=root,
                                     stdout=subprocess.DEVNULL, stderr=err)}


def launch_finish(run, timeout=400):
    """Wait for a started run: ``(launcher exit code, its stderr, {gen:
    [each rank's record]}, seconds)``; raises with the ranks' log tails
    when a generation lacks a rank's record."""
    p, label, work, world = run["proc"], run["label"], run["work"], \
        run["world"]
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        rc = p.wait()
    secs = time.perf_counter() - run["t0"]
    run["err"].seek(0)
    err = run["err"].read()
    run["err"].close()
    gens = {}
    for name in sorted(os.listdir(work)):
        if name.startswith(f"{label}-gen") and name.endswith(".json"):
            with open(os.path.join(work, name)) as f:
                rec = json.load(f)
            gens.setdefault(rec["gen"], []).append(rec)
    for recs in gens.values():
        recs.sort(key=lambda r: r["rank"])
    if not gens or any(len(r) != world for r in gens.values()):
        logs, tails = run["logs"], []
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, name)) as f:
                tails.append(f"{name}: {f.read()[-1500:]}")
        raise RuntimeError(f"chip_smoke: phase 30 ({label}) rc {rc}: "
                           f"{err[-1500:]} {' | '.join(tails)}")
    return rc, err, gens, secs


def phase_launch(counts, cfg=None) -> dict:
    """Phase 30: launched, durable multi-rank training through
    ``python -m paddle_tpu_torch.distributed.launch``, ``cfg`` (default
    ``LAUNCH``): 4 gloo ranks on this card at GPT-345M's width and
    ``layers`` of its 24 layers, fp32, ``mp=2, sharding=2`` ZeRO 3, 2 x
    1024, async checkpoints every 2 steps, ``steps`` steps. An
    uninterrupted run (two steps more, the params gathered after
    ``steps``, then :func:`guard_probe`) is the reference of (ab), one
    run
    under ``--elastic --max_restarts 1``: (b) a preemption notice at
    ``preempt_at``: every rank's just-in-time checkpoint at that step,
    exit 118, the immediate relaunch at no budget, generation 1 from
    that step (zero lost steps); then (a) rank 2 SIGKILLed after
    ``kill_at``, its async save in flight: the watcher's crash and the
    relaunch on the one restart of the budget (the preemption took
    none), generation 2 from the newest step every rank completed (at
    least the save before, whose commit the last save waited for);
    losses and final params bitwise. (c) ``desync``: 2 ranks at
    ``dp=2``, the consistency check every 2 steps and a desync planted
    on rank 0 at step 3: both ranks raise ``DesyncError`` at step 4
    naming ``params_hash`` and rank 0, exit 119, and the launcher says
    desync; (d) (ab)'s newest checkpoint resumes on one rank in this
    process: its next two losses (the second after an update that reads
    the loaded moments) within 1e-5 of the reference's. Every rank's
    launches equal ``ring_launches`` of the steps it ran; the counts of
    every run are summed. The reference, (c) and (ab) share nothing and
    start together (10 ranks on the card; (ab)'s generations 1 and 2 run
    alone)."""
    cfg, desync = cfg or LAUNCH, DESYNC
    L, world = cfg["layers"], cfg["world"]
    mcfg = dataclasses.replace(model_config(), num_layers=L)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if DEV.type == "cuda" else "cpu"
    log(f"[30] launched multi-rank training: python -m paddle_tpu_torch."
        f"distributed.launch, {world} ranks on {DEV} (gloo), GPT-345M width "
        f"at {L} of 24 layers, {cfg['layout']}, fp32 {cfg['batch'][0]} x "
        f"{cfg['batch'][1]}; {smi}")
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    base = {"device": DEV.type, "dir": work,
            "model": dataclasses.asdict(mcfg), "layout": cfg["layout"],
            "batch": list(cfg["batch"]), "seed": 3000, "every": 0,
            "save_every": cfg["save_every"], "root": None,
            "steps": cfg["steps"]}
    n = cfg["steps"]
    fails, out = [], {}

    def per_rank_launches(label, recs_by_gen):
        """Sum the ranks' launches into ``counts``; check each rank's
        against the derivation of the steps it ran."""
        total = dict.fromkeys(K.KERNELS, 0)
        for gen, recs in recs_by_gen.items():
            for r in recs:
                ran = len(r["losses"])
                want = ring_launches(L, 1, ran)
                got = {k: r["launches"].get(k, 0) for k in want}
                if got != want:
                    fails.append(f"({label}) gen {gen} rank {r['rank']}: "
                                 f"launches {got}, derived {want}")
                for k, v in r["launches"].items():
                    total[k] += v
        counts[f"phase30_{label}"] = total

    def losses(recs_by_gen):
        """{step: loss} stitched over the generations (a later one's
        replay of a step must equal the earlier's), after checking every
        rank of a generation reports the same losses."""
        got = {}
        for gen in sorted(recs_by_gen):
            recs = recs_by_gen[gen]
            if any(r["losses"] != recs[0]["losses"] for r in recs):
                fails.append(f"gen {gen}: the ranks' losses differ")
            for s, v in recs[0]["losses"].items():
                if int(s) in got and got[int(s)] != v:
                    fails.append(f"gen {gen} replayed step {s}: {v} != "
                                 f"{got[int(s)]}")
                got[int(s)] = v
        return got

    try:
        K.reset_launch_counts()
        started = {
            "ref": launch_start(
                "ref", dict(base, steps=n + 2, params_at=n, probe=True),
                world, work),
            "c": launch_start(
                "c", dict(base, layout=desync["layout"],
                          every=desync["every"], steps=desync["steps"]),
                desync["world"], work,
                env={"PADDLE_FI_DESYNC_AT_STEP": str(desync["desync_at"])}),
            "ab": launch_start(
                "ab", dict(base, root=os.path.join(work, "ckpt-ab"),
                           params_at=n), world, work,
                args=("--elastic", "--max_restarts", "1"),
                env={"PADDLE_FI_PREEMPT_AT_STEP": str(cfg["preempt_at"]),
                     "PADDLE_FI_KILL_AT_STEP": str(cfg["kill_at"]),
                     "PADDLE_FI_KILL_RANK": str(cfg["kill_rank"])})}
        done = {k: launch_finish(run) for k, run in started.items()}
        rc, err, ref, secs = done["ref"]
        ref_losses = losses(ref)
        ref_params = torch.load(os.path.join(work, "params-ref.pt"))
        per_rank_launches("ref", ref)
        out["reference"] = {"rc": rc, "s": secs, "losses": ref_losses,
                            "probe": [r.get("probe") for r in ref[0]]}
        log(f"  reference: {n + 2} steps, losses {ref_losses}, {secs:.1f} "
            f"s; guard probe {json.dumps(out['reference']['probe'])}")
        if rc:
            fails.append(f"reference run exited {rc}: {err[-500:]}")
        out["ab"] = _launch_faults(done["ab"], cfg, world, work, ref_losses,
                                   ref_params, losses, per_rank_launches,
                                   fails)
        out["c"] = _launch_desync(done["c"], desync, per_rank_launches,
                                  fails)
        out["d"] = _launch_reshard(mcfg, cfg, work, ref_losses, counts,
                                   fails)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(not fails, "phase 30: " + "; ".join(fails))
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase 30: {out['s']:.1f} s")
    return out


def phase_guard_probe(runs=2) -> list:
    """Phase 31: phase 30's world alone on this card, ``runs`` times: 2
    steps, then :func:`guard_probe`."""
    mcfg = dataclasses.replace(model_config(), num_layers=LAUNCH["layers"])
    log(f"[31] guard probe: phase 30's world alone, {runs} runs")
    out = []
    for i in range(runs):
        work = tempfile.mkdtemp(prefix="chip_smoke_probe_")
        spec = {"device": DEV.type, "dir": work,
                "model": dataclasses.asdict(mcfg), "layout": LAUNCH["layout"],
                "batch": list(LAUNCH["batch"]), "seed": 3000, "every": 0,
                "save_every": LAUNCH["save_every"], "root": None, "steps": 2,
                "probe": True}
        try:
            rc, err, gens, secs = launch_finish(launch_start(
                f"probe{i}", spec, LAUNCH["world"], work))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        require(rc == 0, f"phase 31: run {i} exited {rc}: {err[-800:]}")
        m = {"s": secs, "probe": [r["probe"] for r in gens[0]]}
        log(f"  run {i}: " + json.dumps(m))
        out.append(m)
    return out


def _final_params_equal(work, label, ref_params) -> bool:
    got = torch.load(os.path.join(work, f"params-{label}.pt"))
    return got.keys() == ref_params.keys() and all(
        torch.equal(got[k], ref_params[k]) for k in ref_params)


def _launch_faults(finished, cfg, world, work, ref_losses, ref_params,
                   losses, per_rank_launches, fails) -> dict:
    """(ab): a preemption, then a SIGKILL, in one launched run
    (``finished``: its :func:`launch_finish`)."""
    n, at, kill_at = cfg["steps"], cfg["preempt_at"], cfg["kill_at"]
    rank_k = cfg["kill_rank"]
    rc, err, gens, secs = finished
    got = losses(gens)
    per_rank_launches("ab", gens)
    g0, g1, g2 = (gens.get(g, []) for g in (0, 1, 2))
    killed = next((r for r in g1 if r["rank"] == rank_k), {})
    kill_ts = killed.get("last_ts")

    def startup(recs, t0):
        """Each rank's restart: ``t0`` to the rank's first line (the
        watcher, the pod's end, the spawn, imports), then its world, the
        kernels' library, the mesh, the trainer, and the load (to its
        first step)."""
        return [[round(r["ts"]["enter"] - t0, 2)] + [
            round(r["ts"][b] - r["ts"][a], 2) for a, b in (
                ("enter", "world"), ("world", "lib"), ("lib", "mesh"),
                ("mesh", "trainer"), ("trainer", "first_step"))]
            for r in recs]

    steps = [sorted(int(s) for s in r["losses"]) for r in
             (g0[:1] + g1[:1] + g2[:1])]
    preempt_ts = max(r["last_ts"] for r in g0) if g0 else None
    m = {"rc": rc, "s": secs, "generations": len(gens),
         "launcher": [x[:160] for x in err.splitlines()
                      if x.startswith("[launch]")],
         "steps": steps,
         "preempted_at": [r.get("preempted_at") for r in g0],
         "resumed_at": [[r["resumed_at"] for r in g] for g in (g1, g2)],
         "verified_at_kill_resume": g2[0].get("verified") if g2 else None,
         "losses": got,
         "ckpt_bytes_per_rank": [r.get("ckpt_bytes") for r in g2],
         "snapshot_ms": [r["snapshot_ms"] for r in g1 + g2],
         "commit_ms": [r["commit_ms"] for r in g1 + g2],
         "load_ms": [[r.get("load_ms") for r in g] for g in (g1, g2)],
         "preempt_to_gen1_first_step_s": (
             max(r["first_step_ts"] for r in g1) - preempt_ts
             if g1 and preempt_ts else None),
         "kill_to_gen2_first_step_s": (
             max(r["first_step_ts"] for r in g2) - kill_ts
             if g2 and kill_ts else None),
         "gen1_startup_s": startup(g1, preempt_ts) if g1 else None,
         "gen2_startup_s": startup(g2, kill_ts) if g2 and kill_ts else None,
         "step_s": [round(float(np.median(r["step_s"])), 3)
                    for r in g0 + g1 + g2 if r["step_s"]],
         "params_bitwise": _final_params_equal(work, "ab", ref_params)}
    log("  (ab) preemption, then kill and resume: " + json.dumps(m))
    if rc != 0:
        fails.append(f"(ab) launcher exited {rc}: {err[-800:]}")
    if ("[launch] preemption:" not in err
            or "no restart budget consumed" not in err):
        fails.append(f"(b) no immediate relaunch: {err[-800:]}")
    # the peers may fail in their collective inside the settle window
    # and be named beside the killed rank
    if ("[launch] crash: " not in err
            or f"rank {rank_k}: killed by SIGKILL" not in err
            or "relaunch 1/1 (generation 2)" not in err):
        fails.append(f"(a) no crash and relaunch in the launcher's log: "
                     f"{err[-800:]}")
    if m["preempted_at"] != [at] * world or m["resumed_at"][0] != (
            [at] * world):
        fails.append(f"(b) preempted at {m['preempted_at']}, generation 1 "
                     f"resumed at {m['resumed_at'][0]}")
    if steps[:2] != [list(range(1, at + 1)), list(range(at + 1,
                                                        kill_at + 1))]:
        fails.append(f"(b) steps per generation {steps}: a step lost or "
                     "replayed across the preemption")
    # the kill comes after step kill_at's save, which waited for the
    # commit before it: at least that step is complete on every rank
    r2 = m["resumed_at"][1]
    want = max(m["verified_at_kill_resume"] or [0])
    if r2 != [want] * world or want < kill_at - cfg["save_every"]:
        fails.append(f"(a) generation 2 resumed at {r2}, the verified "
                     f"steps were {m['verified_at_kill_resume']}")
    if got != {s: ref_losses[s] for s in range(1, n + 1)}:
        fails.append(f"(ab) losses {got} != the uninterrupted "
                     f"{ref_losses}")
    if not m["params_bitwise"]:
        fails.append("(ab) final params differ from the uninterrupted "
                     "run's")
    return m


def _launch_desync(finished, desync, per_rank_launches, fails) -> dict:
    """(c) a desync planted on rank 0 (``finished``: the run's
    :func:`launch_finish`)."""
    every, at = desync["every"], desync["desync_at"]
    rc, err, gens, secs = finished
    per_rank_launches("c", gens)
    expect = (at + every - 1) // every * every
    recs = gens.get(0, [])
    m = {"rc": rc, "s": secs,
         "desync": [r.get("desync", {}).get("step") for r in recs],
         "classified": "[launch] desync:" in err,
         "error": (recs[0].get("desync") or {}).get("error", "")[:400]}
    log("  (c) desync: " + json.dumps(m))
    if rc == 0 or not m["classified"] or (
            "cross-rank desync (DesyncError, exit 119" not in err):
        fails.append(f"(c) launcher rc {rc}, not classified desync: "
                     f"{err[-800:]}")
    for r in recs:
        e = (r.get("desync") or {}).get("error", "")
        if r.get("desync", {}).get("step") != expect or not (
                "params_hash" in e and "rank 0" in e):
            fails.append(f"(c) rank {r['rank']}: {r.get('desync')}")
    return m


def _launch_reshard(mcfg, cfg, work, ref_losses, counts, fails) -> dict:
    """(d) (ab)'s 4-rank checkpoint (its newest step, the last multiple
    of ``save_every``) on one rank of this process, against the
    reference's next two steps: the second follows an update that reads
    the loaded moments."""
    newest = cfg["steps"] // cfg["save_every"] * cfg["save_every"]
    want = [ref_losses[newest + 1], ref_losses[newest + 2]]
    loader = DrillLoader(3000, *cfg["batch"], mcfg.vocab_size)
    K.reset_launch_counts()
    t = hybrid.HybridParallelTrainer(
        mcfg, multirank_config("float32", zero_stage=3), device=DEV)
    t0 = time.perf_counter()
    step = t.load_checkpoint(os.path.join(work, "ckpt-ab"),
                             dataloader=loader)
    load_ms = (time.perf_counter() - t0) * 1e3
    got = [float(t.step(*loader.next())) for _ in want]
    counts["phase30_d"] = K.launch_counts()
    m = {"resumed_at": step, "cursor": loader.cursor, "losses": got,
         "want": want, "rel_gap": max(abs(g - w) / abs(w)
                                      for g, w in zip(got, want)),
         "load_ms": load_ms}
    log("  (d) reshard to one rank: " + json.dumps(m))
    if step != newest or m["rel_gap"] > 1e-5:
        fails.append(f"(d) {m}")
    del t
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
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
    # template arguments begin: the innermost such one (digits inside
    # nvcc's anonymous-namespace tag can look like an outer length prefix)
    name = m and next((mangled[i:m.start()]
                       for i in reversed(range(m.start()))
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
                    "23,24,25,26,27,28,29,30,32",
                    help="comma-separated; 6, 9, 13, 17 and 18 "
                    "(profiles) and 31 (phase 30's guard probe alone) "
                    "are opt-in")
    ap.add_argument("--drill-worker", metavar="SPEC",
                    help="run one generation of phase 24's preemption drill "
                    "(JSON spec; used by phase 24 itself)")
    ap.add_argument("--rank-worker", metavar="SPEC",
                    help="run one rank of phase 27's or 28's world (JSON "
                    "spec; used by those phases themselves)")
    ap.add_argument("--launch-worker", metavar="SPEC",
                    help="run one launched rank of phase 30 (JSON spec; "
                    "the port's launcher starts it)")
    ap.add_argument("--sass-digests", metavar="LIB",
                    help="print a built kernel library's SASS digests as "
                    "JSON (the form of SASS_REFERENCE) and exit")
    ap.add_argument("--ab", metavar="NAME=DIR,...",
                    help="time the DROP and BIAS variants in each source "
                    "tree in turns (ab_feature_rows) and exit")
    ap.add_argument("--ab-order", metavar="NAME,...",
                    help="--ab's runs, by tree name (default: each tree "
                    "three times, in turns)")
    args = ap.parse_args()
    if args.sass_digests:
        print(json.dumps({"source": Path(args.sass_digests).name,
                          "nvcc": nvcc_version(),
                          "kernels": sass_digests(args.sass_digests)},
                         indent=1, sort_keys=True))
        return 0
    if args.drill_worker:
        return drill_worker(args.drill_worker)
    if args.rank_worker:
        return multirank_worker(args.rank_worker)
    if args.launch_worker:
        return launch_worker(args.launch_worker)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.ab:
        trees = dict(t.split("=", 1) for t in args.ab.split(","))
        order = (args.ab_order.split(",") if args.ab_order
                 else list(trees) * 3)
        ab_feature_rows(trees, order)
        return 0
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
        e2e["train_accuracy"] = phase_train_accuracy(counts,
                                                     layers=ACC_LAYERS)
    if 8 in phases:
        e2e["train"] = phase_train(counts, peaks)
    if 9 in phases:
        e2e["train_profile"] = phase_train_profile()
    if 10 in phases:
        e2e["packed_accuracy"] = phase_packed_accuracy(counts,
                                                       layers=ACC_LAYERS)
    if 11 in phases:
        e2e["packed_train"] = phase_train(counts, peaks, packed=True)
    if 12 in phases:
        e2e["nn_train"] = phase_nn_train(counts, peaks)
    if 13 in phases:
        e2e["packed_profile"] = phase_train_profile(packed=True)
    if 18 in phases:
        e2e["nn_profile"] = phase_nn_profile()
    if 19 in phases:
        e2e["llama_accuracy"] = phase_llama_accuracy(counts, layers=1)
    if 20 in phases:
        e2e["llama_load"] = phase_llama_load(counts)
    if 21 in phases:
        # one trainer step: on the CPU an AdamW step over the 616M
        # parameters costs more than the step's products
        e2e["llama_train_accuracy"] = phase_llama_train_accuracy(
            counts, layers=1, steps=1)
    if 22 in phases:
        e2e["llama_train"] = phase_train(
            counts, peaks, batch=4, seq=2048, mcfg=llama_config(num_layers=4),
            tag="phase22", label="LLaMA-7B width, 4 of 32 layers")
    if 23 in phases:
        e2e["remat"] = phase_remat(counts, peaks, acc_layers=ACC_LAYERS,
                                   speed_layers=CUT_LAYERS)
    if 24 in phases:
        e2e["durability"] = phase_durability(counts)
    if 25 in phases:
        e2e["telemetry"] = phase_telemetry(counts, peaks)
    if 26 in phases:
        e2e["fleet"] = phase_fleet(counts)
    if 27 in phases:
        e2e["multirank"] = phase_multirank(counts)
    if 28 in phases:
        e2e["pipeline"] = phase_multirank(counts, phase=28)
    if 29 in phases:
        e2e["bert"] = phase_bert(counts, peaks)
    if 30 in phases:
        e2e["launch"] = phase_launch(counts)
    if 31 in phases:
        e2e["guard_probe"] = phase_guard_probe()
    if 32 in phases:
        e2e["transformer"] = phase_transformer(counts)
    # the main path: serving (phases 4, 5), training (7, 8), packed
    # training (10, 11), nn-API training (12), speculative (15) and int8
    # (16) serving, the LLaMA phases (19-22), the remat policies (23), the
    # durability drills (24), the telemetry phase (25), the rest of
    # serving (26), multi-rank training (27), pipelines (28, every rank's
    # launches), BERT with varlen attention (29), launched, durable
    # multi-rank training (30, every rank of every generation) and the
    # transformer layers (32), each phase's runs counted
    main_phases = (4, 5, 7, 8, 10, 11, 12, 15, 16, 19, 20, 21, 22, 23, 24,
                   25, 26, 27, 28, 29, 30, 32)

    def launched(which, names=tuple(K.KERNELS)):
        return {name: sum(c.get(name, 0) for key, c in counts.items()
                          if int(key[5:].split("_")[0]) in which)
                for name in names}

    main_path, llama_path = launched(main_phases), launched((19, 20, 21, 22))
    bert_path = launched((29,))
    variant_path = launched(main_phases, VARIANTS)
    if set(main_phases) <= phases:
        missing = [n for n, c in {**main_path, **variant_path}.items()
                   if c == 0]
        require(not missing, f"main path never launched {missing}")
    summary = []
    for name in K.KERNELS:
        r = kern.get(name, {})
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": main_path[name],
            "launches_llama": llama_path[name],
            "launches_bert": bert_path[name],
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "device_ms": r.get("device_ms"), "cold_ms": r.get("cold_ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"), "shape": r.get("shape"),
            **{k: r[k] for k in ("also", "llama", "bert") if k in r},
            "pass": name in kern})
    # the flash kernels' DROP and BIAS variants, each in its base kernel's
    # source, in place of the JAX package's dense path
    for name in VARIANTS:
        r, base = kern.get(name, {}), name.split("+")[0]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[base][0],
            "replaces": VARIANT_REPLACES[base],
            "launches": variant_path[name],
            **{k: r.get(k) for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "shape")},
            "pass": name in kern})
    log(json.dumps({"phase_seconds": phase_seconds(time.perf_counter())}))
    log(json.dumps({"e2e": e2e, "launches_by_phase": counts}))
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
