"""Replica-fleet router: health-probed membership, load-aware placement,
typed retry, and journaled in-flight re-dispatch (port of
``paddle_tpu.serving.router``).

The fault-tolerance layer over N :class:`~.replica.Replica` supervisors:
one scheduler wedging or one replica dying costs a re-dispatch, not the
traffic.

- **membership / circuit breaker**: each replica is probed through its
  health snapshot (the ``/healthz`` readiness: ``overloaded``,
  ``draining``, ``wedged``). Failed probes (dead) and wedges count
  against a per-replica breaker: ``breaker_failures`` consecutive bad
  probes open it (no placement), after ``breaker_reset_s`` it half-opens
  (probes only), and the first good probe closes it again; the
  membership history records the ``recovered`` transition.
- **load-aware placement**: among ready members, the least estimated
  drain time, ``(waiting + running) x tick_s_ema`` from the replica's
  own health snapshot. A ``session_affinity`` hook can pin a session key
  to a replica first.
- **typed client retry**: a placement refused by admission control
  (``RejectedError``) backs off ``max(retry_after_s, base*2^attempt)``
  capped at ``backoff_cap_s`` with deterministic jitter, up to
  ``max_retries`` attempts, then the logical request finishes
  ``rejected`` (counted ``retry_gave_up``).
- **journaled re-dispatch**: the router journals every logical request
  (prompt, budget, tokens already *delivered*). When a replica dies or
  wedges mid-decode, its in-flight requests are re-dispatched to a
  healthy replica as a fresh physical request whose prompt is the
  original prompt + the delivered tokens and whose budget is the
  remainder: the delivered prefix is never generated again (a streaming
  consumer never sees a token twice), and greedy continuations equal a
  single-replica run because every replica serves the same weights. A
  wedged source's physical is cancelled (its pages free at once); a dead
  source's pages went with its engine.
- **rolling restart**: :meth:`ReplicaRouter.rolling_restart` takes one
  replica out of placement, lets its in-flight work finish, drains and
  restarts it, waits for a healthy probe, and only then moves on.

Threading: the router is single-threaded, one owner thread calls
:meth:`submit_request` and :meth:`pump`; replicas may tick on their own
threads (their lock serializes scheduler entry). ``pump`` is cheap and
idempotent.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from ..observability import sink
from ..observability.metrics import registry
from .replica import Replica, ReplicaDown
from .scheduler import RejectedError, Request

__all__ = ["RouterConfig", "LogicalRequest", "ReplicaRouter"]


@dataclasses.dataclass
class RouterConfig:
    probe_interval_s: float = 0.05   # min spacing between probes
    breaker_failures: int = 2        # consecutive bad probes -> open
    breaker_reset_s: float = 0.5     # open -> half-open after this
    max_retries: int = 4             # placement attempts before giving up
    backoff_base_s: float = 0.05     # exp backoff: base * 2^attempt ...
    backoff_cap_s: float = 2.0       # ... capped here
    jitter_frac: float = 0.1         # +- fraction of the delay
    wedge_redispatch: bool = True    # re-dispatch off wedged replicas
    # session-affinity hook: maps (session_key, ready_replica_names)
    # -> the preferred name or None
    session_affinity: Optional[Callable[[str, List[str]],
                                        Optional[str]]] = None


@dataclasses.dataclass
class LogicalRequest:
    """The router's journal entry for one client request — the unit
    that survives replica death. ``delivered`` is the token-offset
    dedup high-water mark: everything in it reached the consumer, so a
    re-dispatch continues strictly after it."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    deadline_s: Optional[float] = None
    session: Optional[str] = None          # affinity key
    # tenancy: the billed tenant rides the JOURNAL, so every physical a
    # re-dispatch mints — on whichever replica — bills the same tenant
    tenant: Optional[str] = None
    # -- runtime (router-owned) ---------------------------------------------
    delivered: List[int] = dataclasses.field(default_factory=list)
    # disaggregation (serving/disagg.py): a failed handoff re-prefills
    # on a DECODE-role replica — the flag pins placement there so the
    # retry cannot bounce through another doomed handoff
    prefer_decode: bool = False
    status: str = "pending"   # pending|placed|finished|timeout|error|
    #                           cancelled|rejected
    replica: Optional[str] = None          # current physical home
    attempts: int = 0                      # rejected placements so far
    redispatches: int = 0
    t_submit: Optional[float] = None
    t_deadline: Optional[float] = None     # absolute, router clock
    reject_reason: Optional[str] = None
    _physical: Optional[Request] = dataclasses.field(
        default=None, repr=False)
    _base: int = 0             # len(delivered) when the physical started
    _retry_at: Optional[float] = None
    _finalized: bool = False

    @property
    def done(self) -> bool:
        return self._finalized


class _Member:
    """Router-side view of one replica: breaker + membership history."""

    def __init__(self, replica: Replica):
        self.replica = replica
        self.breaker = "closed"        # closed | open | half_open
        self.fails = 0                 # consecutive probe failures
        self.opened_at = 0.0
        self.last_probe = None         # last successful health snapshot
        self.t_last_probe: Optional[float] = None
        self.placed_since_probe = 0    # optimistic depth between probes
        self.membership = "healthy"    # healthy|overloaded|draining|
        #                                wedged|dead|recovered
        self.draining = False          # router-initiated (rolling restart)
        self.history: List[str] = ["healthy"]

    @property
    def name(self) -> str:
        return self.replica.name

    def ready(self) -> bool:
        """Placeable right now: breaker closed, not router-draining,
        and the last probe saw a ready (/healthz 200) replica."""
        return (self.breaker == "closed" and not self.draining
                and self.last_probe is not None
                and not self.last_probe.get("overloaded")
                and not self.last_probe.get("draining")
                and not self.last_probe.get("wedged"))

    def score(self) -> float:
        """Estimated drain time: queue depth x rolling decode-tick EMA.
        Placements since the last probe count optimistically toward the
        depth (else a burst all lands on whoever scored lowest at probe
        time); a cold EMA (no tick yet) scores by depth alone — the
        epsilon keeps the product ordered by depth."""
        h = self.last_probe or {}
        depth = (int(h.get("waiting", 0)) + int(h.get("running", 0))
                 + self.placed_since_probe)
        return depth * max(float(h.get("tick_s_ema") or 0.0), 1e-6)


class ReplicaRouter:
    def __init__(self, replicas: List[Replica],
                 clock: Callable[[], float] = time.monotonic,
                 cfg: Optional[RouterConfig] = None, seed: int = 0):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.clock = clock
        self.cfg = cfg or RouterConfig()
        self.members: Dict[str, _Member] = {}
        for r in replicas:
            if r.name in self.members:
                raise ValueError(f"duplicate replica name {r.name!r}")
            self.members[r.name] = _Member(r)
        self.logical: Dict[int, LogicalRequest] = {}
        self.completed: List[LogicalRequest] = []
        self._pending: Deque[LogicalRequest] = deque()
        # deterministic jitter source — virtual-clock drills must replay
        self._rng = np.random.RandomState(seed)
        self.re_dispatches = 0
        self.retries = 0
        self.retry_gave_up = 0
        # disaggregated prefill/decode coordinator hook: a
        # DisaggCoordinator attaches itself here (serving/disagg.py);
        # None = every replica is fused, placement is role-blind
        self.disagg = None
        self._probe_all(self.clock(), force=True)

    # -- intake -------------------------------------------------------------

    def submit_request(self, lr: LogicalRequest) -> LogicalRequest:
        """Journal a logical request and queue it for placement (the
        next :meth:`pump` places it). Returns the journal entry — the
        caller's streaming handle: ``delivered`` grows as harvests pull
        tokens, ``status``/``done`` carry the terminal state."""
        if lr.rid in self.logical:
            raise ValueError(f"duplicate logical rid {lr.rid}")
        now = self.clock()
        lr.t_submit = now
        if lr.deadline_s is not None:
            lr.t_deadline = now + lr.deadline_s
        self.logical[lr.rid] = lr
        self._pending.append(lr)
        registry().counter("fleet_requests_total").inc()
        return lr

    def cancel(self, rid: int) -> bool:
        """Client-side cancel of a logical request: the physical (on
        whichever replica currently holds it) is cancelled — its pages
        free there — and the journal entry finalizes ``cancelled``
        exactly once. False when already terminal or unknown."""
        lr = self.logical.get(rid)
        if lr is None or lr._finalized:
            return False
        self._cancel_physical(lr)
        self._finalize(lr, "cancelled")
        return True

    # -- supervision --------------------------------------------------------

    def pump(self) -> None:
        """One supervision pass (cheap, idempotent): probe due members,
        harvest tokens/terminals from live physicals, re-dispatch
        in-flight work off dead/wedged members, place what is due."""
        now = self.clock()
        self._probe_all(now)
        self._harvest()
        if self.disagg is not None:
            # handoffs advance BEFORE lost-work re-dispatch: a handoff
            # whose source just died/wedged aborts here (requeued with
            # prefer_decode), so _redispatch_lost never double-requeues
            self.disagg.pump(now)
        self._redispatch_lost(now)
        self._place(now)

    def _probe_all(self, now: float, force: bool = False) -> None:
        for m in self.members.values():
            if (not force and m.t_last_probe is not None
                    and now - m.t_last_probe < self.cfg.probe_interval_s):
                continue
            self._probe(m, now)

    def _probe(self, m: _Member, now: float) -> None:
        m.t_last_probe = now
        try:
            h = m.replica.health()
        except ReplicaDown:
            m.last_probe = None
            self._breaker_fail(m, now, "dead")
            return
        m.last_probe = h
        m.placed_since_probe = 0
        if h.get("wedged"):
            # alive but stalled: readiness is 503, and a stalled tick
            # loop is a breaker failure — traffic must stop landing here
            self._breaker_fail(m, now, "wedged")
            return
        # a ready (or merely busy) probe is a breaker success
        if m.breaker == "open":
            if now - m.opened_at >= self.cfg.breaker_reset_s:
                m.breaker = "half_open"
            else:
                return             # still cooling off; ignore the probe
        if m.breaker == "half_open":
            self._transition(m, "recovered")
        m.breaker = "closed"
        m.fails = 0
        if m.draining or h.get("draining"):
            self._transition(m, "draining")
        elif h.get("overloaded"):
            self._transition(m, "overloaded")
        else:
            self._transition(m, "healthy")

    def _breaker_fail(self, m: _Member, now: float, kind: str) -> None:
        m.fails += 1
        self._transition(m, kind)
        if m.breaker == "half_open":
            # failed trial: straight back to open, restart the clock
            m.breaker = "open"
            m.opened_at = now
        elif m.breaker == "closed" and m.fails >= self.cfg.breaker_failures:
            m.breaker = "open"
            m.opened_at = now
        elif m.breaker == "open":
            if now - m.opened_at >= self.cfg.breaker_reset_s:
                m.breaker = "half_open"   # next probe is the trial

    def _transition(self, m: _Member, membership: str) -> None:
        if membership == m.membership:
            return
        m.membership = membership
        m.history.append(membership)
        if sink.enabled():
            sink.emit({"kind": "event", "name": "fleet_membership",
                       "replica": m.name, "membership": membership,
                       "breaker": m.breaker,
                       "generation": m.replica.generation})

    # -- harvest ------------------------------------------------------------

    def _harvest(self) -> None:
        for lr in list(self.logical.values()):
            if lr._finalized or lr._physical is None:
                continue
            phys = lr._physical
            # tokens the physical grew since our last look: its prompt
            # already contains delivered[:_base], so generated[k] is
            # delivered[_base + k] — append strictly beyond our mark
            fresh = phys.generated[len(lr.delivered) - lr._base:]
            if fresh:
                lr.delivered.extend(int(t) for t in fresh)
            if phys.status in ("finished", "timeout", "error"):
                lr._physical = None
                self._finalize(lr, phys.status)
            elif phys.status == "cancelled":
                # cancelled by the REPLICA (drain grace cutoff), not by
                # the client: the work is still owed — re-dispatch
                lr._physical = None
                lr.replica = None
                self._requeue(lr, reason="drain_cancelled")

    # -- re-dispatch --------------------------------------------------------

    def _redispatch_lost(self, now: float) -> None:
        for m in self.members.values():
            lost = (m.last_probe is None and m.breaker != "closed")
            wedged = bool(m.last_probe and m.last_probe.get("wedged"))
            if not lost and not (wedged and self.cfg.wedge_redispatch):
                continue
            for lr in list(self.logical.values()):
                if (lr._finalized or lr.replica != m.name
                        or lr._physical is None):
                    continue
                if wedged:
                    # the source still lives: cancel its physical so the
                    # pages free NOW, not when the wedge clears
                    m.replica.cancel(lr._physical.rid)
                lr._physical = None
                lr.replica = None
                self._requeue(lr, reason="dead" if lost else "wedged")

    def _requeue(self, lr: LogicalRequest, reason: str) -> None:
        lr.redispatches += 1
        self.re_dispatches += 1
        lr.status = "pending"
        self._pending.appendleft(lr)   # lost work goes to the head
        registry().counter("fleet_redispatches_total").inc()
        if sink.enabled():
            sink.emit({"kind": "event", "name": "fleet_redispatch",
                       "rid": lr.rid, "reason": reason,
                       "delivered": len(lr.delivered),
                       "redispatches": lr.redispatches})

    # -- placement ----------------------------------------------------------

    def _ready_members(self) -> List[_Member]:
        return [m for m in self.members.values() if m.ready()]

    def _pick(self, lr: LogicalRequest,
              ready: List[_Member]) -> Optional[_Member]:
        if self.disagg is not None and ready:
            # role-aware placement: fresh requests prefill on a
            # prefill-role member (falling back to decode-capable ones
            # when none is ready — degraded but correct: decode
            # replicas run full engines); continuations and post-failure
            # re-prefills must land decode-side, a prefill-only
            # scheduler would park them forever
            dec = [m for m in ready if m.replica.role != "prefill"]
            if lr.prefer_decode or lr.delivered:
                ready = dec
            else:
                pre = [m for m in ready if m.replica.role == "prefill"]
                ready = pre or dec
        if not ready:
            return None
        if self.cfg.session_affinity is not None and lr.session:
            want = self.cfg.session_affinity(
                lr.session, [m.name for m in ready])
            for m in ready:
                if m.name == want:
                    return m
        return min(ready, key=lambda m: (m.score(), m.name))

    def _place(self, now: float) -> None:
        deferred: List[LogicalRequest] = []
        while self._pending:
            lr = self._pending.popleft()
            if lr._finalized:
                continue
            if lr._retry_at is not None and now < lr._retry_at:
                deferred.append(lr)
                continue
            if lr.t_deadline is not None and now >= lr.t_deadline:
                self._finalize(lr, "timeout")
                continue
            m = self._pick(lr, self._ready_members())
            if m is None:
                deferred.append(lr)    # nobody ready: keep it journaled
                continue
            phys = self._physical_for(lr, now)
            if phys is None:
                continue               # finalized (exhausted budget)
            try:
                m.replica.submit(phys)
            except RejectedError as e:
                self._backoff(lr, e, now)
                if not lr._finalized:
                    deferred.append(lr)
                continue
            except ReplicaDown:
                self._probe(m, now)    # learn it died; try again later
                deferred.append(lr)
                continue
            lr._physical = phys
            lr._base = len(lr.delivered)
            lr.replica = m.name
            lr.status = "placed"
            lr._retry_at = None
            # optimistic accounting, NOT a re-probe: the next pick in
            # this pass sees the deeper queue, but overload is still
            # learned the honest way — a typed rejection racing the
            # probe cadence (which the _backoff path absorbs)
            m.placed_since_probe += 1
        self._pending.extend(deferred)

    def _physical_for(self, lr: LogicalRequest,
                      now: float) -> Optional[Request]:
        """Build the physical continuation: prompt + delivered prefix,
        remaining token budget, remaining TTL. Greedy determinism makes
        the continuation byte-identical to an uninterrupted run; the
        delivered prefix is part of the PROMPT, so it can never be
        re-emitted (the no-duplicate-token guarantee)."""
        remaining = lr.max_new_tokens - len(lr.delivered)
        if remaining <= 0:
            # the source replica died between generating the last token
            # and finishing: everything was delivered, so finish here
            self._finalize(lr, "finished")
            return None
        prompt = np.asarray(lr.prompt, np.int32)
        if lr.delivered:
            prompt = np.concatenate(
                [prompt, np.asarray(lr.delivered, np.int32)])
        ttl = (max(lr.t_deadline - now, 1e-6)
               if lr.t_deadline is not None else None)
        return Request(rid=lr.rid, prompt=prompt,
                       max_new_tokens=remaining,
                       temperature=lr.temperature, top_k=lr.top_k,
                       deadline_s=ttl, tenant=lr.tenant)

    def _backoff(self, lr: LogicalRequest, e: RejectedError,
                 now: float) -> None:
        """Typed retry: honor the server's ``retry_after_s`` hint,
        floor it with capped exponential backoff, spread with jitter.
        ``max_retries`` rejections finalize the request ``rejected``."""
        lr.attempts += 1
        if lr.attempts > self.cfg.max_retries:
            self.retry_gave_up += 1
            lr.reject_reason = e.reason
            registry().counter("fleet_retry_gave_up_total").inc()
            self._finalize(lr, "rejected")
            return
        self.retries += 1
        backoff = min(self.cfg.backoff_cap_s,
                      self.cfg.backoff_base_s * (2 ** (lr.attempts - 1)))
        delay = max(float(e.retry_after_s), backoff)
        jitter = 1.0 + self.cfg.jitter_frac * (
            2.0 * float(self._rng.rand()) - 1.0)
        lr._retry_at = now + delay * jitter
        registry().counter("fleet_retries_total").inc()
        if sink.enabled():
            sink.emit({"kind": "event", "name": "fleet_retry",
                       "rid": lr.rid, "attempt": lr.attempts,
                       "reason": e.reason,
                       "retry_after_s": round(e.retry_after_s, 4),
                       "delay_s": round(delay * jitter, 4)})

    # -- terminal -----------------------------------------------------------

    def _cancel_physical(self, lr: LogicalRequest) -> None:
        if lr._physical is None or lr.replica is None:
            return
        m = self.members.get(lr.replica)
        if m is not None:
            m.replica.cancel(lr._physical.rid)
        lr._physical = None

    def _finalize(self, lr: LogicalRequest, status: str) -> None:
        """Exactly-once terminal transition for a logical request — the
        fleet-level twin of the scheduler's ``_finish``: no matter how
        many physicals a request burned, its journal closes once."""
        if lr._finalized:
            return
        lr._finalized = True
        lr.status = status
        lr.replica = None
        self.completed.append(lr)
        registry().counter(f"fleet_requests_{status}_total").inc()
        if sink.enabled():
            sink.emit({"kind": "event", "name": "fleet_request_done",
                       "rid": lr.rid, "status": status,
                       "tokens": len(lr.delivered),
                       "redispatches": lr.redispatches,
                       "retries": lr.attempts})

    # -- driving ------------------------------------------------------------

    @property
    def in_flight(self) -> int:
        return sum(1 for lr in self.logical.values()
                   if not lr._finalized)

    def _advance(self) -> None:
        """Move the world one notch: threaded replicas advance on their
        own (nap briefly); manual-mode replicas tick once each."""
        ticked = False
        for m in self.members.values():
            if m.replica.threaded:
                ticked = True
        if ticked:
            time.sleep(0.001)
            return
        for m in self.members.values():
            m.replica.tick()

    def run_until_done(self, max_rounds: int = 100_000) -> None:
        """Drive pump + ticks until every journaled request is terminal
        (drills and benches; production callers pump from their own
        loop). Bounded: a fleet with no live replica cannot finish, and
        must fail loudly instead of spinning."""
        rounds = 0
        while self.in_flight:
            self.pump()
            self._advance()
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"fleet stalled: {self.in_flight} request(s) still "
                    f"in flight after {max_rounds} rounds "
                    f"(members: { {m.name: m.membership for m in self.members.values()} })")

    def rolling_restart(self, grace_s: float = 30.0,
                        on_round: Optional[Callable[[], None]] = None
                        ) -> dict:
        """Restart every replica, one at a time, losing nothing: take
        the replica out of placement, keep the fleet running until its
        in-flight work completes (``on_round`` lets a load generator
        keep submitting mid-restart), drain + restart it, wait for a
        healthy probe, then move to the next. Returns a per-replica
        summary."""
        out = {}
        for name in list(self.members):
            m = self.members[name]
            was_threaded = m.replica.threaded
            m.draining = True          # out of placement immediately
            self._transition(m, "draining")
            if sink.enabled():
                sink.emit({"kind": "event",
                           "name": "fleet_rolling_restart",
                           "replica": name, "phase": "drain"})
            rounds = 0
            while any(lr.replica == name and not lr._finalized
                      for lr in self.logical.values()):
                self.pump()
                self._advance()
                if on_round is not None:
                    on_round()
                rounds += 1
                if rounds > 100_000:
                    raise RuntimeError(
                        f"rolling restart stalled draining {name}")
            summary = m.replica.drain(grace_s)
            m.replica.restart()
            if was_threaded:
                m.replica.start()
            # a fresh generation must prove itself ready before the
            # next replica goes down — otherwise a bad restart cascades
            rounds = 0
            while True:
                self._probe(m, self.clock())
                if m.last_probe is not None and m.breaker == "closed":
                    break
                self._advance()
                rounds += 1
                if rounds > 100_000:
                    raise RuntimeError(
                        f"rolling restart: {name} never came back")
            m.draining = False
            self._probe(m, self.clock())
            out[name] = {"drained": summary,
                         "generation": m.replica.generation,
                         "rounds": rounds}
            if sink.enabled():
                sink.emit({"kind": "event",
                           "name": "fleet_rolling_restart",
                           "replica": name, "phase": "done",
                           "generation": m.replica.generation})
        return out

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        """The fleet's identity card: per-replica membership/breaker/
        load, plus the router's re-dispatch and retry counters (the
        JSONL events carry the same numbers)."""
        reps = {}
        up = draining = dead = 0
        for m in self.members.values():
            state = m.replica.state
            if state == "dead":
                dead += 1
            elif state == "draining" or m.draining:
                draining += 1
            else:
                up += 1
            h = m.last_probe or {}
            reps[m.name] = {
                "state": state, "membership": m.membership,
                "breaker": m.breaker,
                "generation": m.replica.generation,
                "running": h.get("running"), "waiting": h.get("waiting"),
                "tick_s_ema": h.get("tick_s_ema"),
                "score": round(m.score(), 6),
                "history": list(m.history),
            }
        snap = {
            "replicas": reps,
            "replicas_up": up, "replicas_draining": draining,
            "replicas_dead": dead,
            "in_flight": self.in_flight,
            "completed": len(self.completed),
            "re_dispatches": self.re_dispatches,
            "retries": self.retries,
            "retry_gave_up": self.retry_gave_up,
        }
        if self.disagg is not None:
            snap["disagg"] = self.disagg.snapshot()
        return snap
