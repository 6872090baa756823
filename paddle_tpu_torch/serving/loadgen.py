"""Synthetic load generation and the continuous-vs-static A/B harness
(port of ``paddle_tpu.serving.loadgen``).

``synthetic_trace`` draws the heavy-traffic mix: Poisson arrivals
(exponential inter-arrival at ``rate_rps``; ``None`` = an offered-load
burst, everything at t=0) over mixed prompt lengths and a heavy-tailed
output-length distribution (80% short chats, 20% long generations), the
regime where static batching pays the most wave quantization: the whole
batch decodes until its LONGEST member finishes. ``repetitious_trace``
is the speculative-decoding family, ``long_prompt_trace`` the
disaggregation one, ``multi_tenant_trace`` the noisy-neighbor one. Every
trace draws from numpy's ``RandomState(seed)`` in the JAX package's
order, so both packages replay the identical requests per seed.

``run_continuous`` drives the continuous-batching scheduler against a
trace by clock; ``run_static_baseline`` is the baseline: the SAME
engine, kernels and paged pool, but sequential full-batch generation
(the next B requests in arrival order, one batch prefill through
K-BSHD, then the whole batch decodes until every member hits its own
``max_new_tokens``). Both return the same report (``_report``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from ..observability.metrics import nearest_rank
from .engine import ServingEngine
from .scheduler import ContinuousBatchingScheduler, RejectedError, Request

__all__ = ["synthetic_trace", "repetitious_trace", "long_prompt_trace",
           "multi_tenant_trace", "prompt_length_report",
           "run_continuous", "run_static_baseline", "percentile",
           "RetryPolicy"]


@dataclasses.dataclass
class RetryPolicy:
    """Client-side retry for typed rejections — the well-behaved
    client the admission controller's ``retry_after_s`` hint assumes.
    Every retry waits at least the server's hint, floored by capped
    exponential backoff and spread with deterministic jitter (seeded —
    virtual-clock runs replay exactly). ``max_retries`` rejections give
    up: counted ``retry_gave_up``, the request stays shed."""
    max_retries: int = 4
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_frac: float = 0.1
    seed: int = 0

    def delay_s(self, attempt: int, retry_after_s: float,
                rng: np.random.RandomState) -> float:
        backoff = min(self.backoff_cap_s,
                      self.backoff_base_s * (2 ** (attempt - 1)))
        jitter = 1.0 + self.jitter_frac * (2.0 * float(rng.rand()) - 1.0)
        return max(float(retry_after_s), backoff) * jitter


def synthetic_trace(n_requests: int, seed: int = 0,
                    rate_rps: Optional[float] = None,
                    prompt_lens=(4, 48), short_out=(4, 16),
                    long_out=(48, 96), long_frac: float = 0.2,
                    vocab_size: int = 1024,
                    deadline_s: Optional[float] = None) -> List[Request]:
    """``n_requests`` synthetic requests sorted by arrival time.
    ``deadline_s`` stamps every request with the same TTL (goodput
    accounting needs a deadline to count against)."""
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        if rate_rps:
            t += float(rng.exponential(1.0 / rate_rps))
        plen = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        lo, hi = long_out if rng.rand() < long_frac else short_out
        reqs.append(Request(
            rid=rid,
            prompt=rng.randint(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.randint(lo, hi + 1)),
            arrival_s=t, deadline_s=deadline_s))
    return reqs


def repetitious_trace(n_requests: int, seed: int = 0,
                      rate_rps: Optional[float] = None,
                      phrase_lens=(6, 12), repeats=(3, 6),
                      out_tokens=(32, 80), vocab_size: int = 1024,
                      deadline_s: Optional[float] = None
                      ) -> List[Request]:
    """The deterministic repetitious/templated trace family (spec-decode
    traffic): each prompt tiles one request-specific random phrase
    several times — templated/boilerplate content, the regime where
    prompt-lookup speculation pays. The n-gram drafter's acceptance on
    ``synthetic_trace``'s i.i.d.-random tokens is ~0 by construction
    (a random next token matches a lookup with probability ~1/vocab);
    repetitious context plus greedy decoding's own repetition loops is
    what the ``serving_spec_acceptance_rate`` row measures. Same Poisson
    arrival machinery as ``synthetic_trace`` (``rate_rps=None`` = one
    offered-load burst), deterministic per seed — both arms of the
    speedup A/B replay the identical trace."""
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        if rate_rps:
            t += float(rng.exponential(1.0 / rate_rps))
        phrase = rng.randint(
            0, vocab_size,
            int(rng.randint(phrase_lens[0], phrase_lens[1] + 1)))
        reps = int(rng.randint(repeats[0], repeats[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=np.tile(phrase, reps).astype(np.int32),
            max_new_tokens=int(rng.randint(out_tokens[0],
                                           out_tokens[1] + 1)),
            arrival_s=t, deadline_s=deadline_s))
    return reqs


def long_prompt_trace(n_requests: int, seed: int = 0,
                      rate_rps: Optional[float] = None,
                      short_prompt=(8, 32), long_prompt=(96, 160),
                      long_frac: float = 0.25, out_tokens=(16, 48),
                      vocab_size: int = 1024,
                      deadline_s: Optional[float] = None
                      ) -> List[Request]:
    """The disaggregation trace: heavy-tailed PROMPT lengths — mostly short chats
    with a ``long_frac`` tail of long-context prompts several times the
    decode budget — the regime where a fused engine's decode ticks
    stall behind long admits and a prefill/decode split pays. Fixed
    seed, same Poisson arrival machinery as ``synthetic_trace``
    (``rate_rps=None`` = one offered-load burst). Use :func:`prompt_length_report` for the
    trace's prompt-length percentiles."""
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        if rate_rps:
            t += float(rng.exponential(1.0 / rate_rps))
        lo, hi = long_prompt if rng.rand() < long_frac else short_prompt
        plen = int(rng.randint(lo, hi + 1))
        reqs.append(Request(
            rid=rid,
            prompt=rng.randint(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.randint(out_tokens[0],
                                           out_tokens[1] + 1)),
            arrival_s=t, deadline_s=deadline_s))
    return reqs


def multi_tenant_trace(n_per_tenant: int, seed: int = 0,
                       tenants=(("flood", 10.0), ("steady", 1.0)),
                       base_rate_rps: Optional[float] = None,
                       prompt_lens=(4, 24), out_tokens=(8, 24),
                       vocab_size: int = 1024,
                       deadline_s: Optional[float] = None
                       ) -> List[Request]:
    """The noisy-neighbor trace: each
    ``(name, rate_mult)`` tenant submits ``n_per_tenant`` requests from
    an independent Poisson process at ``base_rate_rps * rate_mult`` —
    the default is one flooder offering 10x the steady tenant's rate.
    ``base_rate_rps=None`` bursts every tenant at t=0 (the
    fairshare arm: all backlog, pure weighted contention). Rids are
    globally unique; the merged trace is sorted by arrival and
    deterministic per seed."""
    rng = np.random.RandomState(seed)
    reqs = []
    rid = 0
    for name, mult in tenants:
        t = 0.0
        for _ in range(n_per_tenant):
            if base_rate_rps:
                t += float(rng.exponential(
                    1.0 / (base_rate_rps * mult)))
            plen = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
            reqs.append(Request(
                rid=rid,
                prompt=rng.randint(0, vocab_size, plen).astype(np.int32),
                max_new_tokens=int(rng.randint(out_tokens[0],
                                               out_tokens[1] + 1)),
                arrival_s=t, deadline_s=deadline_s, tenant=name))
            rid += 1
    reqs.sort(key=lambda r: (r.arrival_s, r.rid))
    return reqs


def prompt_length_report(trace: List[Request]) -> dict:
    """Prompt-length shape of a trace: its percentiles, so "the trace
    was long-prompt" is a recorded fact, not an assumption."""
    lens = [len(r.prompt) for r in trace]
    return {
        "prompt_len_p50": int(percentile(lens, 0.50)),
        "prompt_len_p90": int(percentile(lens, 0.90)),
        "prompt_len_p99": int(percentile(lens, 0.99)),
        "prompt_len_max": int(max(lens)) if lens else 0,
        "prompt_tokens_total": int(sum(lens)),
    }


def percentile(values, q) -> float:
    """Nearest-rank percentile — the shared repo-wide definition
    (``observability.metrics.nearest_rank``), re-exported under the
    name loadgen callers always used."""
    return nearest_rank(values, q)


def _tenant_report(reqs: List[Request], t0: float,
                   rejected_by_tenant: Optional[dict] = None) -> dict:
    """Per-tenant roll-up of a multi-tenant run: request counts, token
    totals, preemptions, and end-to-end latency/TTFT percentiles keyed
    by tenant: the isolation numbers."""
    by: dict = {}
    for r in reqs:
        by.setdefault(r.tenant, []).append(r)
    for name in (rejected_by_tenant or {}):
        by.setdefault(name, [])   # a fully-shed tenant still gets a row
    out = {}
    for name, rs in sorted(by.items(), key=lambda kv: str(kv[0])):
        ok = [r for r in rs if r.status == "finished"]
        lat = [(r.t_done - (t0 + r.arrival_s)) * 1e3 for r in ok]
        ttft = [(r.t_first_token - (t0 + r.arrival_s)) * 1e3 for r in ok
                if r.t_first_token is not None]
        out[name] = {
            "requests": len(rs),
            "completed": len(ok),
            "rejected": int((rejected_by_tenant or {}).get(name, 0)),
            "tokens": sum(len(r.generated) for r in rs),
            "preemptions": sum(r.preemptions for r in rs),
            "latency_ms_p50": round(percentile(lat, 0.50), 3),
            "latency_ms_p99": round(percentile(lat, 0.99), 3),
            "ttft_ms_p50": round(percentile(ttft, 0.50), 3),
            "ttft_ms_p99": round(percentile(ttft, 0.99), 3),
        }
    return out


def _report(reqs: List[Request], wall_s: float, t0: float,
            mode: str, rejected: int = 0, retried: int = 0,
            retry_gave_up: int = 0,
            rejected_by_tenant: Optional[dict] = None) -> dict:
    """Roll up a run. Latency percentiles cover COMPLETED requests only
    (a cancelled request has no meaningful service latency); goodput is
    tokens from requests that completed within their own deadline."""
    ok = [r for r in reqs if r.status == "finished"]
    lat = [(r.t_done - (t0 + r.arrival_s)) * 1e3 for r in ok]
    ttft = [(r.t_first_token - (t0 + r.arrival_s)) * 1e3 for r in ok
            if r.t_first_token is not None]
    tokens = sum(len(r.generated) for r in reqs)
    good = sum(len(r.generated) for r in ok
               if r.t_deadline is None or r.t_done <= r.t_deadline)
    # inter-token latency pooled across completed requests, from the
    # scheduler's per-token commit stamps: tokens committed the same
    # tick share a timestamp, so this is tick-granular ITL — the same
    # definition the tracer's request_trace itl_ms_p50/p95 use
    itl = []
    for r in ok:
        ts = r.t_tokens
        itl.extend((ts[i] - ts[i - 1]) * 1e3 for i in range(1, len(ts)))
    sp = sum(r.spec_proposed for r in reqs)
    sa = sum(r.spec_accepted for r in reqs)
    rep = {
        "mode": mode,
        "requests": len(reqs),
        "completed": len(ok),
        "timeouts": sum(1 for r in reqs if r.status == "timeout"),
        "errors": sum(1 for r in reqs if r.status == "error"),
        "cancelled": sum(1 for r in reqs if r.status == "cancelled"),
        "rejected": int(rejected),
        "retried": int(retried),
        "retry_gave_up": int(retry_gave_up),
        "decode_tokens_per_sec": tokens / wall_s if wall_s > 0 else 0.0,
        "goodput_tokens_per_sec": good / wall_s if wall_s > 0 else 0.0,
        "requests_per_sec": len(reqs) / wall_s if wall_s > 0 else 0.0,
        "total_tokens": tokens,
        "wall_s": round(wall_s, 4),
        "latency_ms_p50": round(percentile(lat, 0.50), 3),
        "latency_ms_p99": round(percentile(lat, 0.99), 3),
        "ttft_ms_p50": round(percentile(ttft, 0.50), 3),
        "ttft_ms_p99": round(percentile(ttft, 0.99), 3),
        "itl_ms_p50": round(percentile(itl, 0.50), 3),
        "itl_ms_p99": round(percentile(itl, 0.99), 3),
        "preemptions": sum(r.preemptions for r in reqs),
        # speculative-decoding accounting (all zero on non-spec runs)
        "spec_proposed": int(sp),
        "spec_accepted": int(sa),
        "spec_acceptance_rate": round(sa / sp, 4) if sp else 0.0,
    }
    if rejected_by_tenant or any(r.tenant is not None for r in reqs):
        rep["tenants"] = _tenant_report(reqs, t0, rejected_by_tenant)
    return rep


def run_continuous(engine: ServingEngine, trace: List[Request],
                   clock: Callable[[], float] = time.monotonic,
                   scheduler: Optional[ContinuousBatchingScheduler] = None,
                   retry: Optional[RetryPolicy] = None) -> dict:
    """Continuous batching over the trace: requests are submitted when
    their arrival offset elapses, the scheduler iterates whenever there
    is work (idle gaps spin on the clock — synthetic traces are dense
    enough that real sleeps would only add noise).

    ``scheduler`` lets callers drive a pre-built scheduler (one with a
    tracer, an SLO plane or an HTTP endpoint attached); it must wrap
    the same ``engine``.

    ``retry`` opts the client into honoring typed rejections: a shed
    submit re-queues at ``now + RetryPolicy.delay_s(...)`` (at least the
    server's ``retry_after_s``) instead of being dropped; a request shed
    ``max_retries + 1`` times counts ``rejected`` AND ``retry_gave_up``.
    Without it, rejections are counted and never retried (the default
    trace client moves on)."""
    sched = scheduler or ContinuousBatchingScheduler(engine, clock=clock)
    pending = sorted(trace, key=lambda r: r.arrival_s)
    t0 = clock()
    i = 0
    rejected = 0
    retried = 0
    retry_gave_up = 0
    rejected_by_tenant: dict = {}
    retryq: List[tuple] = []   # (due offset, attempts, Request), sorted
    rng = (np.random.RandomState(retry.seed)
           if retry is not None else None)
    while i < len(pending) or retryq or sched.has_work:
        now = clock() - t0

        def _submit(req: Request, attempts: int) -> None:
            nonlocal rejected, retried, retry_gave_up
            try:
                sched.submit(req)
            except RejectedError as e:
                if retry is not None and attempts < retry.max_retries:
                    retried += 1
                    due = now + retry.delay_s(
                        attempts + 1, e.retry_after_s, rng)
                    retryq.append((due, attempts + 1, req))
                    retryq.sort(key=lambda t: t[0])
                else:
                    # shed for good: the client-side view of load
                    # shedding (with retry: after exhausting its budget)
                    rejected += 1
                    name = e.tenant or req.tenant
                    if name is not None:
                        rejected_by_tenant[name] = (
                            rejected_by_tenant.get(name, 0) + 1)
                    if retry is not None:
                        retry_gave_up += 1

        while retryq and retryq[0][0] <= now:
            _, attempts, req = retryq.pop(0)
            _submit(req, attempts)
        while i < len(pending) and pending[i].arrival_s <= now:
            _submit(pending[i], 0)
            i += 1
        if sched.has_work:
            sched.step()
    wall = clock() - t0
    rep = _report(sched.finished, wall, t0, "continuous",
                  rejected=rejected, retried=retried,
                  retry_gave_up=retry_gave_up,
                  rejected_by_tenant=rejected_by_tenant)
    rep["decode_steps"] = sched._steps
    rep.update(_kv_fields(engine))
    _emit_summary(rep)
    return rep


def run_static_baseline(engine: ServingEngine, trace: List[Request],
                        batch_size: Optional[int] = None,
                        clock: Callable[[], float] = time.monotonic
                        ) -> dict:
    """Sequential static-batch generation (the pre-continuous-batching
    baseline): next B requests in arrival order, batch prefill (padded
    rows), then the WHOLE batch decodes in lockstep until its slowest
    member finishes. Same engine, same kernels, same pool."""
    bs = batch_size or engine.cfg.max_batch
    reqs = sorted(trace, key=lambda r: r.arrival_s)
    t0 = clock()
    done: List[Request] = []
    for start in range(0, len(reqs), bs):
        batch = reqs[start:start + bs]
        # the batch cannot launch before its last member arrives (the
        # batch-collection wait static serving always pays) — on a
        # burst trace this is a no-op
        while clock() - t0 < batch[-1].arrival_s:
            pass
        for r in batch:
            r.t_submit = clock()
        pages = []
        ps = engine.kv.page_size
        for r in batch:
            n = -(-(len(r.prompt) + r.max_new_tokens) // ps)
            r.pages = engine.pool.allocate(n)
            pages.append(r.pages)
            r.context_len = len(r.prompt)
        logits = engine.prefill_batch([r.prompt for r in batch], pages)
        now = clock()
        for r, row in zip(batch, logits):
            r.generated.append(int(engine.sample(
                row[None], r.temperature, r.top_k)[0]))
            r.t_tokens.append(now)
            r.t_first_token = now
            if r.done:
                r.t_done = now
        steps = max(r.max_new_tokens for r in batch) - 1
        pt = np.zeros((len(batch), engine.max_pages_per_seq), np.int32)
        for i, r in enumerate(batch):
            pt[i, :len(r.pages)] = r.pages
        for _ in range(steps):
            tokens = np.asarray([r.last_token for r in batch], np.int32)
            lens = np.asarray([r.context_len for r in batch], np.int32)
            logits = engine.decode(tokens, pt, lens)
            now = clock()
            for i, r in enumerate(batch):
                # finished members ride along as dead weight (their rows
                # still cost a full decode lane — the wave-quantization
                # tax being measured) but are frozen: context stays put,
                # output discarded
                if r.done:
                    continue
                r.context_len += 1
                tok = int(engine.sample(logits[i][None], r.temperature,
                                        r.top_k)[0])
                r.generated.append(tok)
                r.t_tokens.append(now)
                if r.done:
                    r.t_done = now
        now = clock()
        for r in batch:
            if r.t_done is None:
                r.t_done = now
            r.status = "finished"
            engine.pool.free(r.pages)
            r.pages = []
        done.extend(batch)
    wall = clock() - t0
    rep = _report(done, wall, t0, "static")
    rep.update(_kv_fields(engine))
    _emit_summary(rep)
    return rep


def _kv_fields(engine: ServingEngine) -> dict:
    """The pool's identity card on every summary: which kv dtype served
    the run, the pool's effective page count, and what the int8 scale
    pools cost (0 outside int8 mode) — so a throughput delta between
    two runs can be attributed to a kv-dtype or capacity change from
    the report alone."""
    kv = engine.kv
    return {"kv_dtype": kv.kv_dtype, "kv_pages": kv.num_pages,
            "kv_pool_bytes": kv.pool_bytes(),
            "kv_scale_pool_bytes": kv.scale_pool_bytes()}


def _emit_summary(rep: dict) -> None:
    from ..observability import sink

    if sink.enabled():
        sink.emit({"kind": "event", "name": "serving_summary", **rep})
