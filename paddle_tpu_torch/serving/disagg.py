"""Disaggregated prefill/decode: the page-granular KV handoff protocol
(port of ``paddle_tpu.serving.disagg``).

A prefill/decode split over the replica fleet: replicas carry a
**role** (``prefill`` | ``decode`` | ``fused``), the router places fresh
requests on a prefill-role member (whose scheduler runs
``prefill_only``: it admits, prefills through K-SEG, samples the first
token, and parks), and :class:`DisaggCoordinator` moves the resulting KV
pages to a decode-role member in four steps::

    lease      pin the source pages under an epoch-stamped PagePool
               lease: neither completion, cancel nor eviction can
               recycle them while the transfer flies
    transfer   allocate destination pages and copy the bytes page by
               page (kv_cache.copy_pages, int8 scales included)
    ack        check that every page arrived (the partial/drop fault
               points truncate here)
    adopt      insert a copy of the physical request (same rid, prompt,
               generated prefix, context_len, remapped page table) into
               the decode scheduler (scheduler.adopt), then cancel the
               source request and release the lease (the deferred frees
               land exactly once)

One stage advances per router pump, so replica chaos (kill, wedge) can
land *between* stages. Every failure degrades to a **re-prefill on a
decode-role replica** through the router's journaled re-dispatch (the
logical request re-queues with ``prefer_decode``; greedy continuations
stay identical because the delivered prefix rides in the new physical's
prompt):

==========================  ============================================
failure                      response
==========================  ============================================
source killed mid-handoff    its pool died with the engine; free any
                             destination pages, re-prefill
source wedged mid-handoff    cancel the parked source request, reclaim
                             the orphaned lease (force-frees the
                             pages), re-prefill
partial / dropped transfer   the ack's count check fails: free the
                             destination pages, cancel + reclaim on the
                             source, re-prefill
decode pool pressure         the destination allocation raises
                             PagesExhausted: cancel + reclaim on the
                             source, re-prefill (admission queues it)
duplicate adopt (retried     scheduler.adopt raises; the coordinator's
ack)                         state machine sends one
==========================  ============================================

A lease whose epoch lost is swept with ``PagePool.reclaim_lease``: no
page leaks on either pool. The transfer and the destination's page
allocation and frees run under both replicas' locks, so a replica
ticking on its own thread never sees its pool change mid-step.

Identity holds for GREEDY lanes (temperature 0 or top_k 0): the transfer
copies exact pool bytes, the adopted request decodes from the same
context through a remapped page table, and a re-prefill is the router's
deterministic continuation.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..observability import sink
from ..observability.metrics import registry
from ..utils import fault_injection as fi
from .kv_cache import PagesExhausted, copy_pages
from .replica import ReplicaDown
from .router import ReplicaRouter
from .scheduler import RejectedError, Request

__all__ = ["DisaggCoordinator", "Handoff"]

# a handoff that cannot adopt (decode batch full) retries each pump;
# past this many deferrals it aborts to re-prefill instead of pinning
# source pages forever
_MAX_ADOPT_DEFERS = 1000


class Handoff:
    """One in-flight lease→transfer→ack→adopt, advanced a stage per
    pump. ``hid`` doubles as the lease epoch."""

    __slots__ = ("hid", "rid", "src", "dst", "lease", "src_pages",
                 "dst_pages", "context_len", "generated",
                 "state", "pages_copied", "stall", "defers",
                 "src_generation")

    def __init__(self, hid: int, rid: int, src: str, dst: str,
                 manifest: dict, src_generation: int):
        self.hid = hid
        self.rid = rid
        self.src = src
        self.dst = dst
        self.lease = manifest["lease_id"]
        self.src_pages: List[int] = list(manifest["pages"])
        self.dst_pages: List[int] = []
        self.context_len = int(manifest["context_len"])
        self.generated: List[int] = list(manifest["generated"])
        self.state = "leased"      # leased|transferred|adopted|aborted
        self.pages_copied = 0
        self.stall = 0             # pumps left to hold the stage (FI)
        self.defers = 0
        self.src_generation = src_generation


class DisaggCoordinator:
    """Attaches to a :class:`~.router.ReplicaRouter` (``router.disagg =
    self``) and drives every handoff from the router's pump loop —
    single-threaded with the router by design, entering replicas only
    through their locked surface."""

    def __init__(self, router: ReplicaRouter):
        self.router = router
        router.disagg = self
        self._active: Dict[int, Handoff] = {}
        self._epoch = 0
        self.handoffs_ok = 0
        self.handoffs_failed = 0
        self.pages_transferred = 0
        self.re_prefills = 0
        self.lease_reclaims = 0
        # chaos knobs resolved once: the pump must not pay env lookups
        # per pass when no drill is armed
        self._fi_drop = fi.armed("handoff_drop")
        self._fi_partial = fi.armed("handoff_partial")
        self._fi_stall = fi.armed("handoff_stall")

    # -- the pump ------------------------------------------------------------

    def pump(self, now: float) -> None:
        """One coordinator pass, called by ``router.pump`` between
        harvest and lost-work re-dispatch: sweep handoffs whose source
        died/wedged (abort + re-prefill), advance each live handoff one
        stage, then open handoffs for prefill-complete requests."""
        for h in list(self._active.values()):
            self._sweep_or_advance(h, now)
        self._begin_handoffs(now)

    def _sweep_or_advance(self, h: Handoff, now: float) -> None:
        r = self.router
        lr = r.logical.get(h.rid)
        m_src = r.members.get(h.src)
        if lr is None or lr._finalized:
            # the journal closed under us (client cancel / timeout):
            # nothing to re-prefill, just sweep the protocol state
            self._abort(h, lr, reason="finalized", requeue=False)
            return
        src_rep = m_src.replica if m_src is not None else None
        dead = (src_rep is None or src_rep.state == "dead"
                or src_rep.generation != h.src_generation
                or (m_src.last_probe is None
                    and m_src.breaker != "closed"))
        wedged = bool(m_src is not None and m_src.last_probe
                      and m_src.last_probe.get("wedged"))
        if dead or wedged:
            self._abort(h, lr,
                        reason="src_dead" if dead else "src_wedged")
            return
        if h.stall > 0:        # PADDLE_FI_HANDOFF_STALL holds the stage
            h.stall -= 1
            return
        if h.state == "leased":
            self._transfer(h, lr)
        elif h.state == "transferred":
            self._ack_and_adopt(h, lr, now)

    # -- stages --------------------------------------------------------------

    def _transfer(self, h: Handoff, lr) -> None:
        r = self.router
        src = r.members[h.src].replica
        m_dst = r.members.get(h.dst)
        if m_dst is None or not m_dst.ready():
            return                 # destination unavailable: wait
        dst = m_dst.replica
        if not h.dst_pages:        # a retried stage keeps its pages
            try:
                with dst._lock:
                    h.dst_pages = dst.engine.pool.allocate(
                        len(h.src_pages))
            except PagesExhausted:
                self._abort(h, lr, reason="pool_pressure")
                return
        limit: Optional[int] = None
        if self._fi_drop and fi.handoff_drop(h.rid, scope=h.src):
            limit = 0
        elif self._fi_partial:
            limit = fi.handoff_partial(h.rid, len(h.src_pages),
                                       scope=h.src)
        try:
            with src._lock, dst._lock:
                h.pages_copied = copy_pages(
                    src.engine.kv, dst.engine.kv, h.src_pages,
                    h.dst_pages, limit=limit)
        except (ReplicaDown, AttributeError):
            # the source engine vanished mid-copy (killed between the
            # dead sweep and here): next pump's sweep sees it dead
            h.pages_copied = -1
            return
        h.state = "transferred"

    def _ack_and_adopt(self, h: Handoff, lr, now: float) -> None:
        r = self.router
        if h.pages_copied != len(h.src_pages):
            self._abort(h, lr, reason=("transfer_drop"
                                       if h.pages_copied == 0
                                       else "partial_transfer"))
            return
        m_dst = r.members.get(h.dst)
        src = r.members[h.src].replica
        phys = lr._physical
        if m_dst is None or phys is None:
            self._abort(h, lr, reason="dst_lost")
            return
        ttl = (max(lr.t_deadline - now, 1e-6)
               if lr.t_deadline is not None else None)
        # clone the parked source physical: same rid/prompt/generated/
        # context, remapped page table — harvest arithmetic (delivered
        # vs _base) carries over unchanged
        it = Request(rid=phys.rid, prompt=phys.prompt,
                     max_new_tokens=phys.max_new_tokens,
                     temperature=phys.temperature, top_k=phys.top_k,
                     deadline_s=ttl, tenant=phys.tenant)
        it.generated = list(h.generated)
        it.context_len = h.context_len
        it.pages = list(h.dst_pages)
        try:
            m_dst.replica.adopt(it)
        except RejectedError:
            h.defers += 1          # decode batch full: retry next pump
            if h.defers > _MAX_ADOPT_DEFERS:
                self._abort(h, lr, reason="adopt_starved")
            return
        except ReplicaDown:
            self._abort(h, lr, reason="dst_lost")
            return
        # ack: the adopt committed — retire the source side exactly once
        try:
            src.complete_handoff(h.rid, h.lease)
        except ReplicaDown:
            pass                   # source died after the copy: its
            #                        pool (and lease) died with it
        h.state = "adopted"
        self._active.pop(h.rid, None)
        lr._physical = it
        lr.replica = h.dst
        lr.status = "placed"
        m_dst.placed_since_probe += 1
        self.handoffs_ok += 1
        self.pages_transferred += h.pages_copied
        registry().counter("serving_handoffs_total").inc()
        registry().counter("serving_handoff_pages_total").inc(
            h.pages_copied)
        if sink.enabled():
            sink.emit({"kind": "event", "name": "kv_handoff",
                       "rid": h.rid, "hid": h.hid, "src": h.src,
                       "dst": h.dst, "status": "adopted",
                       "pages": h.pages_copied})

    # -- failure path --------------------------------------------------------

    def _abort(self, h: Handoff, lr, reason: str,
               requeue: bool = True) -> None:
        """Tear a handoff down to a clean re-prefill: destination pages
        freed, source request cancelled and its lease reclaimed (when
        the source still lives), the logical re-queued decode-side."""
        r = self.router
        h.state = "aborted"
        self._active.pop(h.rid, None)
        m_dst = r.members.get(h.dst)
        if h.dst_pages and m_dst is not None:
            with m_dst.replica._lock:
                if m_dst.replica.engine is not None:
                    m_dst.replica.engine.pool.free(h.dst_pages)
            h.dst_pages = []
        m_src = r.members.get(h.src)
        if (m_src is not None
                and m_src.replica.generation == h.src_generation):
            freed = m_src.replica.abort_handoff(h.lease,
                                                cancel_rid=h.rid)
            if freed or m_src.replica.engine is not None:
                self.lease_reclaims += 1
                registry().counter("serving_lease_reclaims_total").inc()
                if sink.enabled():
                    sink.emit({"kind": "event",
                               "name": "kv_lease_reclaim",
                               "rid": h.rid, "hid": h.hid,
                               "src": h.src, "pages": len(freed)})
        self.handoffs_failed += 1
        registry().counter("serving_handoffs_failed_total").inc()
        if sink.enabled():
            sink.emit({"kind": "event", "name": "kv_handoff",
                       "rid": h.rid, "hid": h.hid, "src": h.src,
                       "dst": h.dst, "status": "failed",
                       "reason": reason, "pages": h.pages_copied})
        if requeue and lr is not None and not lr._finalized:
            lr._physical = None
            lr.replica = None
            lr.prefer_decode = True
            self.re_prefills += 1
            registry().counter("serving_reprefills_total").inc()
            r._requeue(lr, reason=f"handoff_{reason}")

    # -- opening handoffs ----------------------------------------------------

    def _begin_handoffs(self, now: float) -> None:
        r = self.router
        decode_ready = [m for m in r.members.values()
                        if m.ready() and m.replica.role != "prefill"]
        if not decode_ready:
            return
        for lr in list(r.logical.values()):
            if (lr._finalized or lr._physical is None
                    or lr.rid in self._active):
                continue
            m_src = r.members.get(lr.replica)
            if m_src is None or m_src.replica.role != "prefill":
                continue
            phys = lr._physical
            if phys.status != "running" or not phys.generated:
                continue           # prefill not complete yet
            m_dst = min(decode_ready, key=lambda m: (m.score(), m.name))
            self._epoch += 1
            try:
                manifest = m_src.replica.lease_out(lr.rid, self._epoch)
            except (ReplicaDown, ValueError):
                continue           # died/raced: the sweeps handle it
            h = Handoff(self._epoch, lr.rid, m_src.name, m_dst.name,
                        manifest, m_src.replica.generation)
            if self._fi_stall:
                h.stall = fi.handoff_stall(lr.rid, scope=h.src)
            self._active[lr.rid] = h

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "active": len(self._active),
            "handoffs_ok": self.handoffs_ok,
            "handoffs_failed": self.handoffs_failed,
            "pages_transferred": self.pages_transferred,
            "re_prefills": self.re_prefills,
            "lease_reclaims": self.lease_reclaims,
        }
