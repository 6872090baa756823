"""Continuous-batching scheduler: admit/evict between steps (port of
``paddle_tpu.serving.scheduler``).

The Orca iteration-level scheduling loop over the paged engine: each
:meth:`step` (1) admits waiting requests while pages and the prefill
token budget allow, their contexts packed into ONE segmented prefill;
(2) grows each running request by a page exactly when its length
crosses a page boundary, **evicting** (preempting) the youngest running
request when the pool is exhausted — its pages are freed and it
re-queues at the FRONT of the waiting line to re-prefill
prompt+generated later (recompute-style preemption: greedy decoding
reproduces the identical continuation, so eviction only delays output);
(3) runs one bucketed decode for every running request. Requests leave
the moment they hit their own ``max_new_tokens``.

With ``spec_decode=SpecDecodeConfig(...)`` (or an explicit ``drafter``)
the decode phase becomes the draft->verify->accept loop of **speculative
decoding**: a host-side drafter proposes up to ``k`` continuation tokens
per runner, ONE bucketed verify step scores the whole ``(B, k+1)``
window (K-MQ), and greedy exact-match acceptance commits the longest
matching prefix plus a bonus token: output-identical to plain decoding,
up to ``k+1`` tokens per tick.

Robustness kept from the JAX package: per-request deadlines (expired
requests are cancelled at the next tick boundary, pages freed), a
bounded waiting queue (``max_waiting``), deadline admission control
(``admission_control``: a request whose estimated queue wait plus
service time, from a rolling average of the decode and verify ticks'
wall time, exceeds its deadline is shed at submit) -- both make
:meth:`submit` raise :class:`RejectedError` with a ``retry_after_s``
hint -- the decode anomaly guard (a non-finite logits row fails ONLY
the offending request), and graceful drain: :meth:`drain` stops
admitting, runs in-flight work to completion or a grace cutoff and
emits one ``serving_drain`` summary; :meth:`enable_drain_guard` wires it
to SIGTERM through ``utils.preemption.PreemptionGuard``, so the process
exits 118 as a preempted trainer does.

Multi-tenancy (``tenancy=TenantRegistry(...)``, :mod:`.tenancy`):
admission becomes weighted fair queuing over the tenants' virtual times
(``_wfq_head``), with per-tenant token buckets (``tenant_rate``),
concurrency caps (``tenant_quota``), resident-page quotas and
priority preemption that never takes a tenant below its
``guaranteed_pages`` floor. ``tenancy=None`` costs nothing: every hook
hides behind ``if self.tenancy``.

The fleet's hooks: ``prefill_only=True`` makes a prefill-role scheduler
(it admits, prefills, samples the first token and parks its runners for
a disaggregated handoff, :mod:`.disagg`); :meth:`adopt` takes in a
request whose pages were copied into this pool; ``fi_scope`` (the owning
replica's name) aims the ``PADDLE_FI_SERVE_*`` fault points at one fleet
member.

The ops plane is the JAX package's: every ``serving_*`` counter, gauge
and histogram it records, a :class:`~paddle_tpu_torch.observability.
ServingTracer` (``tracer``: built when the JSONL sink is on, ``None``
turns it off) with per-request phase timelines and per-tick
admit/prefill/decode/evict/draft splits, an optional
:class:`~paddle_tpu_torch.observability.SLOTracker` (``slo``) fed TTFT,
queue wait, tick time and request outcomes, per-token commit times on
each request (``Request.t_tokens``), and :meth:`start_http` for
``/metrics``, ``/healthz`` (503 while shedding or once the tick loop has
stalled past ``stall_threshold_s`` with work queued), ``/slo``,
``/dashboard`` and ``/debug/requests``. Besides, the scheduler keeps
plain per-step host records (``decode_tick_ms``, ``verify_ticks``,
``prefill_calls``) for the caller to summarise.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from ..observability import sink
from ..observability.metrics import registry
from ..observability.tracing import ServingTracer
from ..utils import fault_injection as fi
from .engine import ServingEngine
from .kv_cache import PagesExhausted
from .spec_decode import Drafter, NgramDrafter, SpecDecodeConfig

__all__ = ["Request", "RejectedError", "ContinuousBatchingScheduler"]

_AUTO = object()   # tracer default: one exactly when the sink is on


class RejectedError(RuntimeError):
    """Load shedding: the scheduler refused a request at submit time
    (queue full, its deadline could not be met, the server is draining,
    or a tenant limit: ``tenant_rate`` for a token-bucket overdraw,
    ``tenant_quota`` for the concurrency cap). ``retry_after_s`` is the
    backoff hint (for ``tenant_rate`` the bucket's exact refill time);
    ``tenant`` names the billed tenant when a registry is attached. The
    rejected ``Request`` carries no runtime state and may be resubmitted
    as-is."""

    def __init__(self, msg: str, retry_after_s: float = 0.0,
                 reason: str = "overloaded",
                 tenant: Optional[str] = None):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        self.tenant = tenant


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0           # <=0 or top_k 0: greedy
    top_k: int = 0
    arrival_s: float = 0.0             # offset into the trace (loadgen)
    deadline_s: Optional[float] = None  # TTL from submit (scheduler clock)
    # the tenant whose budgets this request bills (serving/tenancy.py);
    # None: the registry's default tenant. Host-side state only
    tenant: Optional[str] = None
    # -- runtime state (scheduler-owned) ------------------------------------
    generated: List[int] = dataclasses.field(default_factory=list)
    # per-token commit timestamps (scheduler clock), parallel to
    # ``generated``: tokens committed in one tick share that tick's
    # timestamp (the tick-granular inter-token latency)
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    context_len: int = 0               # tokens written to the pool
    status: str = "waiting"   # waiting|running|finished|timeout|error|
    #                           cancelled|rejected
    preemptions: int = 0
    spec_proposed: int = 0             # drafted tokens sent to verify
    spec_accepted: int = 0             # drafted tokens accepted
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_deadline: Optional[float] = None  # absolute (t_submit + deadline_s)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def last_token(self) -> int:
        return self.generated[-1]


class ContinuousBatchingScheduler:
    def __init__(self, engine: ServingEngine, clock=time.monotonic,
                 tracer=_AUTO, max_waiting: Optional[int] = None,
                 admission_control: bool = True,
                 anomaly_guard: bool = True,
                 spec_decode: Optional[SpecDecodeConfig] = None,
                 drafter: Optional[Drafter] = None,
                 slo=None, stall_threshold_s: float = 30.0,
                 prefill_only: bool = False, tenancy=None):
        self.engine = engine
        # prefill-role scheduler (disaggregation, serving/disagg.py):
        # admits and prefills, the first token included, but never
        # decodes; runners park until the handoff coordinator leases
        # their pages away (or a failure path cancels them)
        self.prefill_only = bool(prefill_only)
        # speculative decoding: either knob turns it on; the default
        # drafter is the zero-model n-gram prompt-lookup one
        if drafter is not None and spec_decode is None:
            spec_decode = getattr(drafter, "cfg", None) or SpecDecodeConfig()
        self.spec = spec_decode
        if self.spec is not None and drafter is None:
            drafter = NgramDrafter(k=self.spec.k,
                                   max_ngram=self.spec.max_ngram,
                                   min_ngram=self.spec.min_ngram)
        self.drafter = drafter
        self.clock = clock
        self.max_waiting = max_waiting
        self.admission_control = admission_control
        self.anomaly_guard = anomaly_guard
        # rolling decode- and verify-tick seconds (EMA of perf-counter
        # wall time), the admission controller's one input. It is held
        # against deadlines on ``clock``, so admission control assumes
        # clock ~ wall time (tests with virtual clocks set it directly).
        self._tick_s_ema = 0.0
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self._steps = 0
        self._deadline_live = 0        # live requests carrying a deadline
        self._shedding = False   # latched on reject, cleared once none waits
        # tracer=None disables per-request tracing entirely (the OFF arm
        # of the serving_trace_overhead_ratio measurement); the default
        # builds one exactly when an obs run is active
        if tracer is _AUTO:
            tracer = ServingTracer() if sink.enabled() else None
        self.tracer: Optional[ServingTracer] = tracer
        self.http = None
        # the SLO plane (observability.slo): slo=None disables it, every
        # feed below is behind ``if self.slo is not None``
        self.slo = slo
        if slo is not None and self.tracer is not None:
            self.tracer.slo = slo   # the tracer feeds tick-granular ITL
        # stall detection for /healthz: stamped at every tick end; a
        # live process whose tick loop stopped past the threshold while
        # holding work reads NOT-ready (wedged)
        self.stall_threshold_s = float(stall_threshold_s)
        self._t_last_tick: Optional[float] = None
        # host wall time of every plain decode tick (ms), of every verify
        # tick (ms, committed, proposed, accepted) and of every packed
        # prefill (requests, tokens, ms) — the engine returns host
        # logits, so each is a synchronised time
        self.decode_tick_ms: List[float] = []
        self.verify_ticks: List[tuple] = []
        self.prefill_calls: List[tuple] = []
        # multi-tenancy (serving/tenancy.py): None costs nothing, every
        # tenant hook below hides behind ``if self.tenancy``
        self.tenancy = tenancy
        self._tenant_live: dict = {}   # name -> live (waiting+running)
        if tenancy is not None:
            tenancy.validate(engine.pool.capacity,
                             engine.max_pages_per_seq)
            if slo is not None and tenancy.slo is None:
                # the keyed per-tenant SLO view rides the scheduler's own
                # SLO plane: the same clock, one tracker per tenant
                from .tenancy import TenantSLOView
                tenancy.slo = TenantSLOView(clock=clock)
        self._completed = 0            # status=="finished" terminations
        self._draining = False
        self._drained = False
        self._drain_guard = None
        self._drain_grace_s = 30.0
        # fault points resolved once, so an undrilled tick pays no
        # environment lookups; fi_scope is the owning replica's name
        # ("name@spec" aims a point at one fleet member)
        self.fi_scope: Optional[str] = None
        self._fi_serve = (fi.armed("serve_nan_at_tick")
                          or fi.armed("serve_slow_tick"))
        self._pressure_pages: List[int] = []
        if fi.armed("serve_pool_pressure"):
            press = min(fi.serve_pool_pressure(),
                        max(0, engine.pool.available - 1))
            if press:
                self._pressure_pages = engine.pool.allocate(press)

    # -- the ops endpoint -----------------------------------------------------

    def start_http(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the live ops endpoint for this scheduler (``/metrics``,
        ``/healthz``, ``/slo``, ``/dashboard``, ``/debug/requests``,
        ``/debug/profile``). Returns the bound ``(host, port)`` (with
        ``port=0`` the OS picks one); the endpoint stays on ``self.http``.
        Idempotent. Requests need a tracer: one is created if the
        scheduler was built without."""
        from ..observability.http_endpoint import ObsHTTPEndpoint
        if self.http is not None:
            return (self.http._host, self.http.port)
        if self.tracer is None:
            self.tracer = ServingTracer()
        if self.slo is not None:
            self.tracer.slo = self.slo

        def _requests_snapshot():
            # the request table + the pool's capacity identity, so a
            # /debug/requests scrape alone names the kv configuration
            snap = self.tracer.snapshot()
            kv = self.engine.kv
            snap["kv_dtype"] = kv.kv_dtype
            snap["kv_scale_pool_bytes"] = kv.scale_pool_bytes()
            snap["pages_total"] = self.engine.pool.num_pages
            return snap

        self.http = ObsHTTPEndpoint(
            port=port, host=host, health=self._health_snapshot,
            requests=_requests_snapshot,
            slo=(self.slo.snapshot if self.slo is not None else None),
            slo_tenant=(self.tenancy.slo.snapshot_for
                        if self.tenancy is not None
                        and self.tenancy.slo is not None else None))
        self.http.start()
        return (host, self.http.port)

    def stop_http(self) -> None:
        """Stop the ops endpoint if one is running (idempotent)."""
        http, self.http = self.http, None
        if http is not None:
            http.stop()

    def _health_snapshot(self) -> dict:
        pool = self.engine.pool
        kv = self.engine.kv
        age = (self.clock() - self._t_last_tick
               if self._t_last_tick is not None else None)
        # wedged: the process answers HTTP but the tick loop stopped
        # while still holding work; readiness flips 503 on it
        wedged = bool(self.has_work and age is not None
                      and age > self.stall_threshold_s)
        snap = {
            "role": "serving",
            "tick": self._steps,
            "running": len(self.running),
            "waiting": len(self.waiting),
            "finished": len(self.finished),
            "pages_in_use": pool.in_use,
            "pages_total": pool.num_pages,
            "kv_dtype": kv.kv_dtype,
            "kv_pool_bytes": kv.pool_bytes(),
            "kv_scale_pool_bytes": kv.scale_pool_bytes(),
            "overloaded": self.overloaded,
            "draining": self._draining or self._drained,
            "tick_s_ema": round(self._tick_s_ema, 6),
            "last_tick_age_s": (round(age, 4)
                                if age is not None else None),
            "stall_threshold_s": self.stall_threshold_s,
            "wedged": wedged,
            "slo_alerts_firing": (self.slo.firing_count()
                                  if self.slo is not None else 0),
        }
        if self.tenancy is not None:
            # per-tenant queue occupancy: who waits behind whom
            tens: dict = {}
            for r in self.waiting:
                d = tens.setdefault(r.tenant, {"waiting": 0, "running": 0})
                d["waiting"] += 1
            for r in self.running:
                d = tens.setdefault(r.tenant, {"waiting": 0, "running": 0})
                d["running"] += 1
            snap["tenants"] = tens
        return snap

    def _queue_full(self) -> bool:
        """THE ``max_waiting`` predicate, shared by ``overloaded`` (the
        /healthz readiness) and ``_admission_check`` (submit shedding)."""
        return (self.max_waiting is not None
                and len(self.waiting) >= self.max_waiting)

    @property
    def overloaded(self) -> bool:
        """Is the scheduler shedding load? True while the bounded queue
        is full or since the last rejection until the queue drains."""
        return self._queue_full() or self._shedding

    # -- intake -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        cfg = self.engine.cfg
        if len(req.prompt) + req.max_new_tokens > cfg.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"max_model_len {cfg.max_model_len}")
        if len(req.prompt) == 0 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: empty prompt or "
                             "max_new_tokens < 1")
        worst = self.engine.pages_needed(len(req.prompt),
                                         req.max_new_tokens)
        if worst > self.engine.pool.capacity:
            # admitting would livelock: even an idle pool can never hold
            # it — a misconfiguration, not overload
            raise ValueError(
                f"request {req.rid}: needs up to {worst} KV pages over "
                f"its lifetime but the whole pool holds "
                f"{self.engine.pool.capacity} — it can never run even "
                "on an idle engine (raise num_pages or shrink the "
                "request)")
        if req.generated or req.pages or req.t_done is not None:
            raise ValueError(
                f"request {req.rid} carries runtime state from a "
                "previous run (generated tokens/pages); submit a fresh "
                "Request object")
        self._admission_check(req)
        if self.tenancy is not None:
            self.tenancy.on_admit(req.tenant)
            self._tenant_live[req.tenant] = (
                self._tenant_live.get(req.tenant, 0) + 1)
        req.status = "waiting"
        req.t_submit = self.clock()
        req.t_deadline = (req.t_submit + req.deadline_s
                          if req.deadline_s is not None else None)
        if req.t_deadline is not None:
            self._deadline_live += 1
        registry().counter("serving_requests_total").inc()
        self.waiting.append(req)
        if self.tracer:
            self.tracer.on_submit(req.rid, len(req.prompt),
                                  req.max_new_tokens)

    def _admission_check(self, req: Request) -> None:
        """Every submit-time shedding decision, in the JAX scheduler's
        order (raises :class:`RejectedError` through ``_reject``): drain
        refusal, the bounded queue, deadline admission control, then the
        tenant limits, last because ``tenant_rate`` debits the bucket on
        acceptance (a request the other gates shed must not burn it)."""
        if self.tenancy is not None:
            # resolve early so every rejection bills the right tenant;
            # stamps None -> "default"
            req.tenant = self.tenancy.resolve(req.tenant).name
        if self._draining or self._drained:
            self._reject(req, "draining", self._drain_grace_s)
        if self._queue_full():
            self._reject(req, "queue_full",
                         self._tick_s_ema * len(self.waiting))
        if (self.admission_control and req.deadline_s is not None
                and self._tick_s_ema > 0.0):
            # every queued request costs about one tick of head-of-line
            # delay, and the request itself one tick per new token: if
            # that already exceeds the deadline, admitting it is doomed
            # work that steals ticks from requests that can still make it
            wait_s = self._tick_s_ema * len(self.waiting)
            est_s = wait_s + self._tick_s_ema * req.max_new_tokens
            if est_s > req.deadline_s:
                self._reject(req, "deadline_unmeetable", wait_s)
        if self.tenancy is not None:
            self._tenant_check(req)

    def _tenant_check(self, req: Request) -> None:
        """The tenant admission gates: the live-request cap
        (``tenant_quota``) and the token-bucket rate limit
        (``tenant_rate``, charged prompt + max_new_tokens, the request's
        worst case, with the bucket's refill time as the hint)."""
        t = self.tenancy.resolve(req.tenant)
        if (t.max_concurrent is not None
                and self._tenant_live.get(t.name, 0) >= t.max_concurrent):
            self._reject(req, "tenant_quota", max(self._tick_s_ema, 1e-3),
                         tenant=t.name)
        if t.bucket is not None:
            cost = len(req.prompt) + req.max_new_tokens
            ok, retry = t.bucket.try_take(cost, self.clock())
            if not ok:
                self._reject(req, "tenant_rate", retry, tenant=t.name)

    def _reject(self, req: Request, reason: str, retry_after_s: float,
                tenant: Optional[str] = None) -> None:
        """Shed ``req`` at submit, the hint floored at one tick (and at
        1 ms while no tick has been timed): counter, JSONL event, the
        overload flag the ``/healthz`` readiness reports, and (whatever
        the reason) the request's tenant billed for the shed."""
        retry = max(float(retry_after_s), self._tick_s_ema, 1e-3)
        tenant = tenant or req.tenant
        req.status = "rejected"
        self._shedding = True
        registry().counter("serving_rejected_total").inc()
        if self.slo is not None:
            self.slo.on_shed()
        if self.tenancy is not None and tenant is not None:
            self.tenancy.on_reject(tenant, reason)
            if self.tenancy.slo is not None:
                self.tenancy.slo.for_tenant(tenant).on_shed()
        if sink.enabled():
            rec = {"kind": "event", "name": "request_rejected",
                   "rid": req.rid, "reason": reason,
                   "retry_after_s": round(retry, 4)}
            if tenant is not None:
                rec["tenant"] = tenant
            sink.emit(rec)
        raise RejectedError(
            f"request {req.rid} rejected ({reason}): retry after "
            f"~{retry:.3f}s", retry_after_s=retry, reason=reason,
            tenant=tenant)

    def _observe_tick(self, seconds: float) -> None:
        """Fold one decode or verify tick's wall time into the EMA (the
        first tick sets it)."""
        self._tick_s_ema = (seconds if not self._tick_s_ema
                            else 0.9 * self._tick_s_ema + 0.1 * seconds)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request by id (queued or running): pages freed
        exactly once, status ``cancelled``. False when no live request
        carries ``rid``."""
        for req in list(self.running) + list(self.waiting):
            if req.rid == rid:
                self._finish(req, self.clock(), status="cancelled")
                return True
        return False

    def adopt(self, req: Request) -> None:
        """Take in a request whose KV pages a disaggregated handoff
        copied INTO this scheduler's pool (serving/disagg.py): ``req``
        arrives mid-flight, its pages allocated from this engine's pool
        and holding the copied bytes, ``context_len`` and ``generated``
        carried over from the prefill side. A duplicate adopt (a retried
        ack) and an adopt after free (a page table whose pages were
        recycled) raise ``ValueError``; a full batch raises
        :class:`RejectedError` with reason ``no_slot``, so the
        coordinator can back off without losing the transfer."""
        for live in list(self.running) + list(self.waiting):
            if live.rid == req.rid:
                raise ValueError(
                    f"duplicate adopt of rid {req.rid}: a live request "
                    "already carries it (retried ack?)")
        if not req.pages or not self.engine.pool.is_adoptable(req.pages):
            raise ValueError(
                f"adopt of rid {req.rid}: page table "
                f"{req.pages} is not live in this pool "
                "(adopt-after-free)")
        if len(self.running) >= self.engine.cfg.max_batch:
            raise RejectedError(
                f"adopt of rid {req.rid}: batch full "
                f"({self.engine.cfg.max_batch})",
                retry_after_s=max(self._tick_s_ema, 1e-3),
                reason="no_slot")
        now = self.clock()
        if self.tenancy is not None:
            # admitted (and bucket-charged) on the prefill side: here it
            # only joins the live accounting
            req.tenant = self.tenancy.resolve(req.tenant).name
            self._tenant_live[req.tenant] = (
                self._tenant_live.get(req.tenant, 0) + 1)
        req.status = "running"
        if req.t_submit is None:
            req.t_submit = now
        if req.generated and req.t_first_token is None:
            req.t_first_token = now
        if len(req.t_tokens) < len(req.generated):
            req.t_tokens.extend(
                [now] * (len(req.generated) - len(req.t_tokens)))
        req.t_deadline = (req.t_submit + req.deadline_s
                          if req.deadline_s is not None else None)
        if req.t_deadline is not None:
            self._deadline_live += 1
        self.running.append(req)
        registry().counter("serving_adopted_total").inc()
        if self.tracer:
            self.tracer.on_submit(req.rid, len(req.prompt),
                                  req.max_new_tokens)

    # -- the iteration ------------------------------------------------------

    def step(self) -> None:
        """One serving iteration: the SIGTERM drain guard, deadline
        expiry, admit+prefill, grow/evict, decode."""
        if (self._drain_guard is not None and not self._draining
                and self._drain_guard.preemption_noticed(
                    completed_step=self._steps)):
            self._drain_and_exit()
        if self.tracer:
            self.tracer.begin_tick()
        if self._deadline_live:
            self._expire(self.clock())
        self._admit_and_prefill()
        if self.running and not self.prefill_only:
            if self.spec is not None:
                self._decode_spec()
            else:
                self._decode_plain()
        self._steps += 1
        self._t_last_tick = self.clock()
        if self._shedding and not self.waiting:
            self._shedding = False   # queue drained: overload is over
        registry().gauge("serving_pages_in_use").set(
            self.engine.pool.in_use)
        if self.slo is not None:
            self.slo.maybe_evaluate()
            if self.tenancy is not None and self.tenancy.slo is not None:
                self.tenancy.slo.maybe_evaluate()
        if self.tracer:
            self.tracer.end_tick(
                running=len(self.running), waiting=len(self.waiting),
                pages_in_use=self.engine.pool.in_use,
                pages_total=self.engine.pool.num_pages,
                max_batch=self.engine.cfg.max_batch)

    def run(self) -> None:
        while self.has_work:
            self.step()

    def _expire(self, now: float) -> None:
        """Cancel every live request past its deadline — queued or
        running — through the one ``_finish`` path (status
        ``timeout``)."""
        for req in [r for r in list(self.running) + list(self.waiting)
                    if r.t_deadline is not None and now >= r.t_deadline]:
            self._finish(req, now, status="timeout")

    # -- graceful drain -------------------------------------------------------

    def enable_drain_guard(self, grace_s: float = 30.0, guard=None):
        """Wire SIGTERM/SIGUSR1 to a graceful drain: the next :meth:`step`
        after a preemption notice (a real signal, or the
        ``PADDLE_FI_PREEMPT_AT_STEP`` point consulted each tick) drains
        with ``grace_s`` and raises ``TrainingPreempted``, which exits
        the process with 118 if it propagates. Returns the guard."""
        if guard is None:
            from ..utils.preemption import PreemptionGuard
            guard = PreemptionGuard()
        self._drain_guard = guard
        self._drain_grace_s = float(grace_s)
        return guard

    def _drain_and_exit(self) -> None:
        from ..utils.preemption import TrainingPreempted
        summary = self.drain(self._drain_grace_s)
        raise TrainingPreempted(
            f"serving drain complete: {summary['completed']} completed, "
            f"{summary['cancelled']} cancelled in "
            f"{summary['drain_wall_s']}s", step=self._steps)

    def drain(self, grace_s: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting new submissions (they shed
        with reason ``draining``), keep stepping until every in-flight
        request completes or ``grace_s`` elapses on the clock, cancel the
        rest (pages freed), and emit ONE ``serving_drain`` JSONL summary,
        which it returns. The scheduler refuses work afterwards."""
        t0 = self.clock()
        self._draining = True
        self._drain_grace_s = float(grace_s)
        done0 = self._completed
        timeouts0 = sum(1 for r in self.finished if r.status == "timeout")
        leftovers: List[Request] = []
        try:
            while self.has_work and (self.clock() - t0) < grace_s:
                self.step()
            now = self.clock()
            leftovers = list(self.waiting) + list(self.running)
            for req in leftovers:
                self._finish(req, now, status="cancelled")
        finally:
            self._draining = False
            self._drained = True
        wall = self.clock() - t0
        summary = {
            "completed": self._completed - done0,
            "cancelled": len(leftovers),
            "timeouts": sum(1 for r in self.finished
                            if r.status == "timeout") - timeouts0,
            "drain_wall_s": round(wall, 4),
            "grace_s": float(grace_s),
            "pages_in_use": self.engine.pool.in_use,
        }
        registry().counter("serving_drains_total").inc()
        if sink.enabled():
            sink.emit({"kind": "event", "name": "serving_drain",
                       **summary})
        return summary

    # -- phases -------------------------------------------------------------

    def _prefill_tokens(self, req: Request) -> np.ndarray:
        """The context a (re-)admission must write to the pool: prompt +
        everything already generated EXCEPT the newest token (whose K/V
        the next decode step writes)."""
        if req.generated:
            return np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.generated, np.int32)])[:-1]
        return np.asarray(req.prompt, np.int32)

    def _admit_and_prefill(self) -> None:
        cfg = self.engine.cfg
        ps = self.engine.kv.page_size
        batch: List[Request] = []
        toks: List[np.ndarray] = []
        total = 0
        # tracer-only clock: the untraced tick does not pay the call
        t_admit = time.perf_counter() if self.tracer else None
        while self.waiting and len(self.running) + len(batch) < cfg.max_batch:
            req = (self.waiting[0] if self.tenancy is None
                   else self._wfq_head(batch))
            if req is None:
                break   # every queued tenant is over its page quota
            ctx = self._prefill_tokens(req)
            if batch and total + len(ctx) > cfg.max_prefill_tokens:
                break
            n_pages = -(-len(ctx) // ps)
            try:
                pages = self.engine.pool.allocate(n_pages)
            except PagesExhausted:
                if (not self.running and not batch
                        and self.engine.pool.in_use == 0):
                    raise RuntimeError(
                        f"request {req.rid} needs {n_pages} pages but "
                        f"the whole pool holds "
                        f"{self.engine.pool.available} — pool smaller "
                        "than max_pages_per_seq, misconfigured engine")
                # head-of-line request cannot fit NOW: never skip past it
                # (FIFO fairness; under tenancy, the fair-share pick);
                # wait for completions/evictions
                break
            if self.tenancy is None:
                self.waiting.popleft()
            else:
                self.waiting.remove(req)
                # the admitted context bills the tenant's virtual time
                # (decode tokens bill as they commit)
                self.tenancy.charge(req.tenant, len(ctx))
            req.pages = pages
            req.context_len = len(ctx)
            batch.append(req)
            toks.append(ctx)
            total += len(ctx)
        if self.tracer:
            self.tracer.acc(
                "admit_ms", (time.perf_counter() - t_admit) * 1e3)
        if not batch:
            return
        # queue wait ends where the prefill begins; read the clock once
        # for the whole batch, only when the SLO plane is on
        t_q = self.clock() if self.slo is not None else None
        pf_us = time.time() * 1e6 if self.tracer else None
        t0 = time.perf_counter()
        logits = self.engine.prefill_packed(toks, [r.pages for r in batch])
        pf_ms = (time.perf_counter() - t0) * 1e3
        self.prefill_calls.append((len(batch), total, pf_ms))
        if self.tracer:
            self.tracer.on_prefill([r.rid for r in batch], pf_us, pf_ms)
        now = self.clock()
        for req, row in zip(batch, logits):
            req.status = "running"
            self.running.append(req)
            if not req.generated:       # first admission: the TTFT token
                tok = int(self.engine.sample(
                    row[None], req.temperature, req.top_k)[0])
                req.generated.append(tok)
                req.t_tokens.append(now)
                req.t_first_token = now
                registry().counter("serving_tokens_generated_total").inc()
                if self.slo is not None and req.t_submit is not None:
                    self.slo.observe_ttft((now - req.t_submit) * 1e3)
                    self.slo.observe_queue_wait(
                        (t_q - req.t_submit) * 1e3)
            # re-admission after eviction: the newest generated token is
            # already known; the prefill only rebuilt the pool pages
            if req.done:
                self._finish(req, now)

    def _wfq_head(self, batch: List[Request]) -> Optional[Request]:
        """Weighted-fair admission pick: each tenant's FIFO head
        competes, the ELIGIBLE tenant with the lowest virtual time wins,
        and arrival order holds within a tenant. A tenant whose resident
        pages (running + this tick's batch) would pass its
        ``max_resident_pages`` stays queued this tick (never shed).
        Returns None when nobody is eligible."""
        heads: dict = {}
        for r in self.waiting:
            if r.tenant not in heads:
                heads[r.tenant] = r
        ps = self.engine.kv.page_size
        resident = None
        best = best_key = None
        for name, r in heads.items():
            t = self.tenancy.resolve(name)
            if t.max_resident_pages is not None:
                if resident is None:
                    resident = self._pages_by_tenant(batch)
                clen = len(r.prompt) + (len(r.generated) - 1
                                        if r.generated else 0)
                need = -(-clen // ps)
                if resident.get(name, 0) + need > t.max_resident_pages:
                    continue
            key = (t.vtime, str(name))
            if best_key is None or key < best_key:
                best_key, best = key, r
        if best is not None:
            self.tenancy.note_pick(best.tenant)
        return best

    def _pages_by_tenant(self, extra=()) -> dict:
        """Resident KV pages per tenant (running requests + ``extra``,
        the admission batch being assembled)."""
        out: dict = {}
        for r in self.running:
            out[r.tenant] = out.get(r.tenant, 0) + len(r.pages)
        for r in extra:
            out[r.tenant] = out.get(r.tenant, 0) + len(r.pages)
        return out

    def _grow_or_evict(self, extra=None) -> None:
        """Each running request about to write tokens at positions
        ``context_len .. context_len + extra(req)`` needs pages through
        ``(context_len + extra(req)) // ps``; allocate boundary pages,
        evicting the youngest runner on exhaustion. ``extra`` (the
        speculative draft length; ``None``: the plain one-token write)
        keeps provisioning exact for up-to-(k+1)-token ticks; a rejected
        draft's pages stay the request's own future pages, freed on its
        one ``_finish`` exit, so rejection never leaks pages."""
        ps = self.engine.kv.page_size
        for req in list(self.running):
            if req.status != "running":
                continue
            top = req.context_len + (extra(req) if extra else 0)
            need = top // ps + 1 - len(req.pages)
            if need <= 0:
                continue
            while True:
                try:
                    req.pages.extend(self.engine.pool.allocate(need))
                    break
                except PagesExhausted:
                    avail0 = self.engine.pool.available
                    victim = self._pick_victim(exclude=req)
                    if victim is not None:
                        self._evict(victim, for_req=req)
                    elif self.engine.pool.available <= avail0:
                        raise RuntimeError(
                            "page pool exhausted with a single running "
                            "request — pool smaller than "
                            "max_pages_per_seq, misconfigured engine")
                    # else: _pick_victim cancelled past-deadline runners,
                    # freeing pages — retry the allocation

    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        """Youngest running request (vLLM recompute policy) — but never
        one already past its deadline: those are cancelled on the spot
        (their pages free at once) and the scan goes on.

        With a tenancy registry the pick is priority preemption: among
        the candidates, the lowest-priority tenant with the most pages
        above its ``guaranteed_pages`` floor, youngest request first,
        and never a victim whose eviction would take its tenant below
        the floor. Returns None when every candidate is protected."""
        now = None
        cands: List[Request] = []
        for req in list(reversed(self.running)):  # youngest first
            if req is exclude or req.status != "running":
                continue
            if req.t_deadline is not None:
                if now is None:
                    now = self.clock()
                if now >= req.t_deadline:
                    self._finish(req, now, status="timeout")
                    continue
            if self.tenancy is None:
                return req
            cands.append(req)
        if self.tenancy is None or not cands:
            return None
        resident = self._pages_by_tenant()
        best = best_key = None
        for req in cands:   # youngest first: ties keep the youngest
            t = self.tenancy.resolve(req.tenant)
            have = resident.get(req.tenant, 0)
            if have - len(req.pages) < t.guaranteed_pages:
                continue   # would push the tenant below its floor
            key = (t.priority, -(have - t.guaranteed_pages))
            if best_key is None or key < best_key:
                best_key, best = key, req
        return best

    def _evict(self, req: Request,
               for_req: Optional[Request] = None) -> None:
        """Recompute-style preemption: free the pages, requeue at the
        FRONT so the victim re-prefills (prompt + generated) next.
        ``for_req``, the request the pages go to, of another tenant makes
        this a cross-tenant preemption."""
        self.engine.pool.free(req.pages)
        req.pages = []
        req.context_len = 0
        req.status = "waiting"
        req.preemptions += 1
        self.running.remove(req)
        self.waiting.appendleft(req)
        cross = (for_req is not None and req.tenant is not None
                 and for_req.tenant != req.tenant)
        if self.tenancy is not None:
            self.tenancy.on_preempt(req.tenant, cross=cross)
        registry().counter("serving_preemptions_total").inc()
        if cross:
            registry().counter(
                "serving_cross_tenant_preemptions_total").inc()
        if self.tracer:
            self.tracer.on_evict(req.rid)
        if sink.enabled():
            rec = {"kind": "event", "name": "serving_preemption",
                   "rid": req.rid, "generated": len(req.generated)}
            if req.tenant is not None:
                rec["tenant"] = req.tenant
                rec["cross_tenant"] = cross
            sink.emit(rec)

    def _decode_plain(self) -> None:
        ev0 = time.perf_counter() if self.tracer else None
        self._grow_or_evict()
        if self.tracer:
            self.tracer.acc(
                "evict_ms", (time.perf_counter() - ev0) * 1e3)
        runners = [r for r in self.running if r.status == "running"]
        if not runners:
            return
        maxp = self.engine.max_pages_per_seq
        pt = np.zeros((len(runners), maxp), np.int32)
        for i, r in enumerate(runners):
            pt[i, :len(r.pages)] = r.pages
        tokens = np.asarray([r.last_token for r in runners], np.int32)
        lens = np.asarray([r.context_len for r in runners], np.int32)
        dc_us = time.time() * 1e6 if self.tracer else None
        t0 = time.perf_counter()
        logits = self.engine.decode(tokens, pt, lens)
        if self._fi_serve:
            logits = self._inject_faults(runners, logits)
        dur_s = time.perf_counter() - t0
        dur_ms = dur_s * 1e3
        self.decode_tick_ms.append(dur_ms)
        self._observe_tick(dur_s)
        registry().histogram("serving_decode_step_ms").observe(dur_ms)
        registry().counter("serving_decode_steps_total").inc()
        if self.slo is not None:
            self.slo.observe_tick(dur_ms)
        if self.tracer:
            self.tracer.on_decode_tick(
                [r.rid for r in runners], dc_us, dur_ms)
        if self.anomaly_guard and not np.isfinite(float(logits.sum())):
            # cheap scalar screen; the per-row scan runs only on anomaly
            runners, logits = self._fail_anomalous(runners, logits)
            if not runners:
                return
        now = self.clock()
        if all(not r.top_k or r.temperature <= 0 for r in runners):
            toks = self.engine.sample(logits)
        else:
            toks = np.asarray([
                self.engine.sample(logits[i][None], r.temperature,
                                   r.top_k)[0]
                for i, r in enumerate(runners)], np.int32)
        tokens_total = registry().counter("serving_tokens_generated_total")
        for i, req in enumerate(runners):
            req.context_len += 1
            req.generated.append(int(toks[i]))
            req.t_tokens.append(now)
            tokens_total.inc()
            if self.tenancy is not None:
                self.tenancy.charge(req.tenant, 1)
            if req.done:
                self._finish(req, now)

    def _decode_spec(self) -> None:
        """The draft->verify->accept tick: propose up to ``k`` tokens per
        runner (truncated to the request's remaining budget minus one,
        the bonus token, and to zero past its deadline), provision pages
        for the whole window through the same grow/evict logic, run ONE
        bucketed verify at the fixed ``(B, k+1)`` window, and commit the
        longest draft prefix matching the verify argmax plus its bonus
        token. The committed tokens are the verify step's own greedy
        choices, so greedy output equals the plain engine's; an empty
        draft everywhere takes the plain one-token decode tick."""
        k = self.spec.k
        # propose BEFORE page growth so provisioning covers the window
        # actually drafted; an eviction below orphans its draft
        dr0 = time.perf_counter() if self.tracer else None
        now = self.clock()
        drafts: dict = {}
        for req in self.running:
            if req.status != "running":
                continue
            budget = min(k, req.max_new_tokens - len(req.generated) - 1)
            if req.t_deadline is not None and now >= req.t_deadline:
                budget = 0   # never draft past the deadline
            if budget <= 0 or (req.top_k and req.temperature > 0):
                # non-greedy requests ride the window as a plain decode:
                # exact-match acceptance is a greedy-only identity
                drafts[req.rid] = []
                continue
            ctx = req.prompt.tolist() + req.generated
            d = self.drafter.propose(ctx, budget)
            drafts[req.rid] = [int(t) for t in d[:budget]]
        if self.tracer:
            self.tracer.acc(
                "draft_ms", (time.perf_counter() - dr0) * 1e3)
        if not any(drafts.values()):
            # nothing drafted anywhere: a verify window would spend (k+1)x
            # the decode work to commit one token per lane
            return self._decode_plain()
        ev0 = time.perf_counter() if self.tracer else None
        self._grow_or_evict(extra=lambda r: len(drafts.get(r.rid, ())))
        if self.tracer:
            self.tracer.acc(
                "evict_ms", (time.perf_counter() - ev0) * 1e3)
        runners = [r for r in self.running if r.status == "running"]
        if not runners:
            return
        w = k + 1   # fixed window
        tokens = np.zeros((len(runners), w), np.int32)
        maxp = self.engine.max_pages_per_seq
        pt = np.zeros((len(runners), maxp), np.int32)
        for i, r in enumerate(runners):
            tokens[i, 0] = r.last_token
            d = drafts.get(r.rid, ())
            if d:
                tokens[i, 1:1 + len(d)] = d
            pt[i, :len(r.pages)] = r.pages
        lens = np.asarray([r.context_len for r in runners], np.int32)
        dc_us = time.time() * 1e6 if self.tracer else None
        t0 = time.perf_counter()
        logits = self.engine.verify(tokens, pt, lens)  # (n, w, vocab)
        if self._fi_serve:
            logits = self._inject_faults(runners, logits)
        dur_ms = (time.perf_counter() - t0) * 1e3
        self._observe_tick(dur_ms / 1e3)
        registry().histogram("serving_decode_step_ms").observe(dur_ms)
        registry().counter("serving_decode_steps_total").inc()
        if self.slo is not None:
            self.slo.observe_tick(dur_ms)
        if self.anomaly_guard and not np.isfinite(float(logits.sum())):
            runners, logits = self._fail_anomalous(runners, logits)
        if not runners:
            self.verify_ticks.append((dur_ms, 0, 0, 0))
            return
        now = self.clock()
        greedy = np.argmax(logits, axis=-1).astype(np.int32)  # (n, w)
        commits = []
        committed = proposed = accepted = 0
        for i, req in enumerate(runners):
            d = drafts.get(req.rid, [])
            if req.top_k and req.temperature > 0:
                toks = [int(self.engine.sample(
                    logits[i, 0][None], req.temperature, req.top_k)[0])]
                m = 0
            else:
                g = greedy[i]
                m = 0
                while m < len(d) and d[m] == int(g[m]):
                    m += 1
                # longest matching prefix + the bonus token: row m's
                # argmax is the model's next token AFTER the accepted
                # prefix, what a plain decode there would emit
                toks = d[:m] + [int(g[m])]
            commits.append((req, len(d), m, toks))
            proposed += len(d)
            accepted += m
            committed += len(toks)
        self.verify_ticks.append((dur_ms, committed, proposed, accepted))
        registry().counter("serving_tokens_generated_total").inc(committed)
        if proposed:
            registry().counter("serving_spec_proposed_total").inc(proposed)
        if accepted:
            registry().counter("serving_spec_accepted_total").inc(accepted)
        if self.tracer:
            self.tracer.on_decode_tick(
                [r.rid for r in runners], dc_us, dur_ms,
                tokens=committed, spec_proposed=proposed,
                spec_accepted=accepted)
        for req, n_d, m, toks in commits:
            req.spec_proposed += n_d
            req.spec_accepted += m
            req.context_len += len(toks)
            if self.tenancy is not None:
                self.tenancy.charge(req.tenant, len(toks))
            req.generated.extend(toks)
            # a verify tick commits its whole window at the tick end:
            # every committed token shares the timestamp (per-tick ITL)
            req.t_tokens.extend([now] * len(toks))
            if req.done:
                self._finish(req, now)

    def _inject_faults(self, runners: List[Request],
                       logits: np.ndarray) -> np.ndarray:
        """Fault points on the decode output (armed runs only): poison
        one request's logits row with NaN and/or stretch the tick."""
        rid = fi.serve_nan_at_tick(self._steps, scope=self.fi_scope)
        if rid is not None:
            for i, r in enumerate(runners):
                if r.rid == rid:
                    logits = np.array(logits, copy=True)
                    logits[i, :] = np.nan
                    break
        secs = fi.serve_slow_tick(self._steps, scope=self.fi_scope)
        if secs:
            time.sleep(secs)
        return logits

    def _fail_anomalous(self, runners: List[Request], logits: np.ndarray):
        """Non-finite logits fail ONLY the offending request(s): status
        ``error``, pages freed; survivors keep their own logits rows.
        Handles both the decode ``(n, vocab)`` and the verify
        ``(n, w, vocab)`` layouts."""
        row_ok = np.isfinite(logits.reshape(len(runners), -1).sum(axis=-1))
        now = self.clock()
        for i in np.flatnonzero(~row_ok):
            req = runners[int(i)]
            print(f"[serving] non-finite logits for rid {req.rid} at "
                  f"tick {self._steps}: failing the request, pages "
                  "freed; batch-mates unaffected",
                  file=sys.stderr, flush=True)
            self._finish(req, now, status="error")
        keep = np.flatnonzero(row_ok)
        return [runners[int(i)] for i in keep], logits[keep]

    def _finish(self, req: Request, now: float,
                status: str = "finished") -> None:
        """The single exit path for every terminal status: pages freed
        exactly once, the request leaves whichever structure holds
        it."""
        req.status = status
        req.t_done = now
        if req in self.running:
            self.running.remove(req)
        elif status != "finished":
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        if req.pages:
            self.engine.pool.free(req.pages)
            req.pages = []
        if req.t_deadline is not None:
            self._deadline_live -= 1
        if self.tenancy is not None and req.tenant is not None:
            n = self._tenant_live.get(req.tenant, 1) - 1
            self._tenant_live[req.tenant] = max(0, n)
        self.finished.append(req)
        latency_ms = (now - req.t_submit) * 1e3 if req.t_submit else None
        ttft_ms = ((req.t_first_token - req.t_submit) * 1e3
                   if req.t_first_token and req.t_submit else None)
        if status == "finished":
            self._completed += 1
            registry().counter("serving_requests_completed_total").inc()
            if latency_ms is not None:
                registry().histogram(
                    "serving_request_latency_ms").observe(latency_ms)
            if ttft_ms is not None:
                registry().histogram("serving_ttft_ms").observe(ttft_ms)
        elif status == "timeout":
            registry().counter("serving_timeouts_total").inc()
        elif status == "error":
            registry().counter("serving_request_errors_total").inc()
        elif status == "cancelled":
            registry().counter("serving_cancelled_total").inc()
        if self.slo is not None:
            # goodput numerator = tokens from requests that finished
            # within their own deadline (loadgen's definition)
            good = (len(req.generated) if status == "finished"
                    and (req.t_deadline is None or now <= req.t_deadline)
                    else 0)
            self.slo.on_request_done(status, tokens=len(req.generated),
                                     good_tokens=good)
            if (self.tenancy is not None and self.tenancy.slo is not None
                    and req.tenant is not None):
                # the keyed per-tenant SLO view, fed once per request at
                # its terminal: TTFT, tick-granular ITL gaps, outcome
                tr = self.tenancy.slo.for_tenant(req.tenant)
                tr.on_request_done(status, tokens=len(req.generated),
                                   good_tokens=good)
                if ttft_ms is not None:
                    tr.observe_ttft(ttft_ms)
                ts = req.t_tokens
                if len(ts) > 1:
                    tr.observe_itl_many(
                        [(ts[i] - ts[i - 1]) * 1e3
                         for i in range(1, len(ts))])
        if sink.enabled():
            rec = {"kind": "event", "name": "request_done",
                   "rid": req.rid, "status": status,
                   "tokens": len(req.generated),
                   "prompt_tokens": int(len(req.prompt)),
                   "latency_ms": (round(latency_ms, 3)
                                  if latency_ms is not None else None),
                   "ttft_ms": (round(ttft_ms, 3)
                               if ttft_ms is not None else None),
                   "preemptions": req.preemptions}
            if req.tenant is not None:
                rec["tenant"] = req.tenant
            if self.spec is not None:
                rec["spec_proposed"] = req.spec_proposed
                rec["spec_accepted"] = req.spec_accepted
            sink.emit(rec)
        if self.tracer:
            self.tracer.on_finish(req.rid, latency_ms, ttft_ms,
                                  tokens=len(req.generated),
                                  status=status,
                                  spec_proposed=req.spec_proposed,
                                  spec_accepted=req.spec_accepted)
