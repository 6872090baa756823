"""Replica supervisor: one engine + scheduler behind a crash boundary
(port of ``paddle_tpu.serving.replica``).

A :class:`Replica` wraps a ``ServingEngine`` +
:class:`~paddle_tpu_torch.serving.scheduler.ContinuousBatchingScheduler`
pair behind the process-like lifecycle the router needs: it owns the
tick loop (a thread of its own via :meth:`start`, or caller-driven
:meth:`tick` for deterministic drills), exposes the scheduler's health
snapshot (the ``/healthz`` readiness: overloaded, draining, wedged), its
:meth:`drain`, and a :meth:`restart` that rebuilds the engine+scheduler
pair from factories (a new generation, as a relaunched serving process
would be).

Failure emulation is first-class, so the fleet drills run inside one
process:

- :meth:`kill` drops the scheduler AND engine mid-flight: nothing is
  drained, in-flight requests freeze where they were. Every later call
  answers :class:`ReplicaDown`, what a router probing a crashed process
  sees. The engine's pool must then really be freed on the card: the
  replica keeps no reference to it, and the scheduler's ops endpoint
  (whose callbacks hold the scheduler) is stopped first.
- :meth:`wedge` opens a no-op window on the replica's clock:
  :meth:`tick` returns without stepping, so the scheduler's
  ``last_tick_age_s`` goes stale and its health snapshot flips
  ``wedged``, as for a stuck tick loop, with no real time spent under a
  virtual clock.

Both can be armed from the environment
(``PADDLE_FI_ROUTER_KILL_REPLICA=name:tick``,
``PADDLE_FI_ROUTER_WEDGE_REPLICA=name:tick[:secs]``) and compose with the
per-tick ``PADDLE_FI_SERVE_*`` points, which take a ``"name@spec"`` scope
(the scheduler's ``fi_scope`` is stamped with the replica's name here).

Threading: one re-entrant lock serializes every entry into the scheduler
and its engine (each step's host copy of the logits included); the tick
thread and router-side calls interleave at tick granularity. The current
CUDA device is per thread, so the tick thread sets the engine's device
before its first step.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from ..observability import sink
from ..utils import fault_injection as fi
from .engine import ServingEngine
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["Replica", "ReplicaDown"]


class ReplicaDown(RuntimeError):
    """The replica is dead (killed / crashed): every interaction —
    submit, probe, cancel — answers this, the in-process analog of a
    connection refused from a crashed serving process."""


class Replica:
    """Supervisor for one engine+scheduler pair; see the module doc.

    ``make_engine`` / ``make_scheduler`` are factories so
    :meth:`restart` can rebuild the pair from scratch:
    ``make_engine() -> ServingEngine`` and
    ``make_scheduler(engine) -> ContinuousBatchingScheduler``. The
    default scheduler factory builds a plain scheduler on the replica's
    clock. Factories should share ONE model object across replicas —
    identical weights are what make re-dispatched greedy continuations
    byte-identical to the reference run.
    """

    def __init__(self, name: str,
                 make_engine: Callable[[], ServingEngine],
                 make_scheduler: Optional[Callable[..., object]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 role: str = "fused"):
        if role not in ("fused", "prefill", "decode"):
            raise ValueError(f"replica role must be 'fused', 'prefill' "
                             f"or 'decode', got {role!r}")
        self.name = name
        self.role = role
        self.clock = clock
        self._make_engine = make_engine
        self._make_scheduler = make_scheduler or (
            lambda eng: ContinuousBatchingScheduler(
                eng, clock=clock, prefill_only=(role == "prefill")))
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._run_flag = False         # tick-thread liveness (unlocked:
        #                                written by owner, read by thread)
        self.generation = 0
        self.state = "up"              # up | draining | dead
        self.engine: Optional[ServingEngine] = None
        self.scheduler = None
        self._wedged_until = 0.0
        # chaos knobs resolved once: the tick loop must not pay env
        # lookups per tick when no drill is armed
        self._fi_kill = fi.armed("router_kill_replica")
        self._fi_wedge = fi.armed("router_wedge_replica")
        with self._lock:
            self._boot_locked()

    # -- lifecycle ----------------------------------------------------------

    def _boot_locked(self) -> None:
        self.engine = self._make_engine()
        self.scheduler = self._make_scheduler(self.engine)
        # stamp the chaos scope: "name@spec" PADDLE_FI_SERVE_* hooks
        # fire only inside this replica's scheduler
        self.scheduler.fi_scope = self.name
        self.state = "up"
        self._wedged_until = 0.0

    def start(self, idle_sleep_s: float = 0.0005) -> "Replica":
        """Spawn the replica's own tick thread (daemon): steps whenever
        the scheduler holds work, naps ``idle_sleep_s`` otherwise.
        Idempotent while running."""
        if self._thread is not None:
            return self
        self._run_flag = True
        dev = self.engine.device if self.engine is not None else None

        def loop():
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
            while self._run_flag:
                if not self.tick():
                    time.sleep(idle_sleep_s)

        self._thread = threading.Thread(
            target=loop, name=f"replica-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the tick thread (if any) and join it — idempotent. The
        scheduler and its state survive; this only parks the loop."""
        self._run_flag = False
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    @property
    def threaded(self) -> bool:
        return self._thread is not None

    def restart(self) -> "Replica":
        """Rebuild the engine+scheduler pair from the factories — a new
        generation, as if the serving process relaunched. Works from any
        state (drained, dead, wedged); the tick thread is NOT restarted
        automatically (callers that ran threaded call :meth:`start`)."""
        self.stop()
        with self._lock:
            old = self.scheduler
            if old is not None:
                old.stop_http()
            self._boot_locked()
            self.generation += 1
        self._emit_state("up")
        return self

    def kill(self) -> None:
        """Simulate a crash: drop the scheduler and engine on the floor
        mid-flight. No drain, no page bookkeeping — in-flight requests
        freeze exactly where the last tick left them, and their
        generated-but-unharvested tokens are LOST (the router's journal
        is the only survivor, which is the point of the drill)."""
        self.stop()
        with self._lock:
            sched = self.scheduler
            if sched is not None:
                sched.stop_http()
            self.scheduler = None
            self.engine = None
            self.state = "dead"
        self._emit_state("dead")

    def wedge(self, secs: float) -> None:
        """Open a ``secs``-long no-op window on the replica's clock:
        ticks return without stepping, ``last_tick_age_s`` goes stale,
        and the scheduler's own health flips ``wedged`` once its stall
        threshold passes. Direct-call twin of the
        ``PADDLE_FI_ROUTER_WEDGE_REPLICA`` knob."""
        with self._lock:
            self._wedged_until = self.clock() + float(secs)

    # -- the tick ------------------------------------------------------------

    def tick(self) -> bool:
        """One supervised scheduler step. Returns True when a step ran;
        False while dead, wedged, or idle. Chaos hooks are consulted at
        the tick boundary, so a kill lands *between* decode steps — the
        same place a SIGKILL lands for a process whose tick loop is the
        only thread touching the engine."""
        with self._lock:
            sched = self.scheduler
            if sched is None:
                return False
            now = self.clock()
            if self._fi_kill and fi.router_kill_replica(
                    self.name, sched._steps):
                self._kill_locked()
                return False
            if self._fi_wedge:
                secs = fi.router_wedge_replica(self.name, sched._steps)
                if secs:
                    self._wedged_until = now + secs
            if now < self._wedged_until:
                return False        # wedged: alive but not ticking
            if not sched.has_work:
                return False
            sched.step()
            return True

    def _kill_locked(self) -> None:
        sched = self.scheduler
        if sched is not None:
            sched.stop_http()
        self.scheduler = None
        self.engine = None
        self.state = "dead"
        self._emit_state("dead")

    # -- router-facing surface ----------------------------------------------

    def submit(self, req: Request) -> None:
        """Forward to the scheduler (its admission control may raise
        ``RejectedError``); :class:`ReplicaDown` when dead."""
        with self._lock:
            sched = self._alive_locked()
            sched.submit(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request on this replica (False when the
        replica is dead or holds no such request). Works while wedged —
        the wedge parks the tick loop, not the lock — which is how the
        router frees a superseded re-dispatch source's pages."""
        with self._lock:
            if self.scheduler is None:
                return False
            return self.scheduler.cancel(rid)

    def health(self) -> dict:
        """The scheduler's ``/healthz`` body plus replica identity
        (name / state / generation). Raises :class:`ReplicaDown` when
        dead — probes must see the same failure a crashed process
        gives, not a polite JSON answer."""
        with self._lock:
            sched = self._alive_locked()
            snap = sched._health_snapshot()
            if self.clock() < self._wedged_until:
                # the scheduler's own detector needs has_work + a stale
                # tick; an emulated wedge must read wedged even once the
                # router cancelled everything off this replica — else
                # the idle wedge looks healthy and placement thrashes
                snap["wedged"] = True
            snap.update({"replica": self.name, "state": self.state,
                         "generation": self.generation,
                         "role": self.role})
            return snap

    def drain(self, grace_s: float = 30.0) -> dict:
        """Graceful drain through the supervisor: parks the tick
        thread first (the drain loop steps the scheduler itself), then
        drains and stops the per-replica HTTP endpoint. The replica
        stays ``draining`` — placeable again only after
        :meth:`restart`."""
        self.stop()
        with self._lock:
            sched = self._alive_locked()
            self.state = "draining"
            self._emit_state("draining")
            summary = sched.drain(grace_s)
            sched.stop_http()
            return summary

    # -- disaggregated handoff surface (serving/disagg.py) -------------------

    def prefill_ready(self) -> list:
        """Rids of running requests whose prefill is complete (>= 1
        generated token — the TTFT token the prefill pass samples) and
        that are therefore ready to hand their KV pages to a decode
        replica. :class:`ReplicaDown` when dead."""
        with self._lock:
            sched = self._alive_locked()
            return [r.rid for r in sched.running
                    if r.status == "running" and r.generated]

    def lease_out(self, rid: int, epoch: int) -> dict:
        """Pin rid's KV pages under an epoch-stamped pool lease (the
        handoff's *lease* step) and return the transfer manifest:
        ``{lease_id, pages, context_len, generated, max_new_tokens}``.
        The pages stay owned by the request — the lease only guarantees
        they cannot be recycled while the copy is in flight."""
        with self._lock:
            sched = self._alive_locked()
            for req in sched.running:
                if req.rid == rid and req.status == "running":
                    lid = self.engine.pool.lease(req.pages, epoch)
                    return {"lease_id": lid, "pages": list(req.pages),
                            "context_len": req.context_len,
                            "generated": list(req.generated),
                            "max_new_tokens": req.max_new_tokens}
            raise ValueError(
                f"lease_out: no running request {rid} on {self.name}")

    def complete_handoff(self, rid: int, lease_id: int) -> None:
        """The *ack* landed and the decode side adopted: cancel the
        source request (its free defers under the lease) and release the
        lease, which actually frees the pages — exactly once, whatever
        order the cancel and release interleave with other traffic."""
        with self._lock:
            sched = self._alive_locked()
            sched.cancel(rid)
            self.engine.pool.release_lease(lease_id)

    def abort_handoff(self, lease_id: int,
                      cancel_rid: Optional[int] = None) -> list:
        """The transfer's epoch lost (failure mid-handoff): cancel the
        parked source request if asked, then reclaim the orphaned lease
        — force-freeing anything it still pins. No-op (returns [])
        when the replica is dead: the pool died with the engine."""
        with self._lock:
            if self.scheduler is None or self.engine is None:
                return []
            if cancel_rid is not None:
                self.scheduler.cancel(cancel_rid)
            return self.engine.pool.reclaim_lease(lease_id)

    def adopt(self, req: Request) -> None:
        """Forward a transferred request into this replica's scheduler
        (the *adopt* step); :class:`ReplicaDown` when dead. Duplicate
        adopt and adopt-after-free raise from the scheduler."""
        with self._lock:
            sched = self._alive_locked()
            sched.adopt(req)

    @property
    def has_work(self) -> bool:
        with self._lock:
            return (self.scheduler is not None
                    and self.scheduler.has_work)

    def _alive_locked(self):
        if self.scheduler is None:
            raise ReplicaDown(f"replica {self.name} is down")
        return self.scheduler

    def _emit_state(self, state: str) -> None:
        if sink.enabled():
            sink.emit({"kind": "event", "name": "fleet_replica_state",
                       "replica": self.name, "state": state,
                       "generation": self.generation})
