"""Per-request serving traces + scheduler tick accounting (the ops plane;
port of ``paddle_tpu.observability.tracing``, pure Python).

Production continuous-batching systems (Orca's iteration-level
scheduling, vLLM's request-lifecycle metrics — PAPERS.md) treat two
signals as first-class: the *request timeline* (where did this request
spend its life: queued, prefilling, decoding, preempted?) and the
*scheduler tick* (what did each iteration spend its wall on, how full
was the batch, how hot was the page pool?). :class:`ServingTracer`
records both from ``serving/scheduler.py``:

- every request gets a **trace id** (its rid) and a phase timeline
  ``submit -> queued -> prefill -> decode -> [preempted -> prefill ->
  decode ...] -> done``. Decode is accumulated per tick into one open
  span (a 96-token generation is ONE decode span carrying
  ``ticks``/``tokens``, not 96 records); an eviction closes it and opens
  a ``preempted`` span, so a recomputed request renders as ONE trace
  with a visible preemption gap. The full timeline is emitted as a
  single ``request_trace`` JSONL event when the request finishes.
- every scheduler iteration emits a ``tick`` JSONL record with the
  admit/prefill/decode/evict wall split, batch occupancy, page-pool
  utilization, and tokens generated this tick.

``tools/obs_report.py --timeline`` merges both with the span stream
into one Chrome/Perfetto trace;
``--ticks`` renders the per-iteration accounting. The in-flight request
table (:meth:`ServingTracer.snapshot`) backs the HTTP endpoint's
``/debug/requests`` route, so every method is safe to call concurrently
with an HTTP reader thread (one RLock; snapshots are deep-copied).

Timestamps are ``t0_us`` unix microseconds (the span-record convention)
so serving phases, train-step spans, and compile events land on one
merged timeline regardless of which subsystem emitted them.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from . import sink
from .metrics import nearest_rank, registry

__all__ = ["ServingTracer", "PHASES"]

#: the phase vocabulary, in lifecycle order
PHASES = ("queued", "prefill", "decode", "preempted")

_FINISHED_KEEP = 64   # recent finished requests kept for /debug/requests
_TICK_RING = 4096     # global tick-end timestamps kept for ITL gaps


def _now_us() -> float:
    return time.time() * 1e6


class ServingTracer:
    """Collects request phase timelines and per-tick accounting.

    The scheduler drives it; nothing here touches the engine or the card.
    All methods are thread-safe (the HTTP endpoint's reader thread calls
    :meth:`snapshot` concurrently with the serving loop).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._reqs: Dict[int, Dict[str, Any]] = {}   # in flight, by rid
        self._finished: deque = deque(maxlen=_FINISHED_KEEP)
        self._tick = 0
        self._cur: Optional[Dict[str, Any]] = None   # open tick accumulator
        # decode accounting is O(1) per tick, NOT per running request:
        # spans are sealed lazily against the last decode-step end, and a
        # span's tick count is the delta of this global counter — the
        # tracer must never add per-request work to the decode hot path
        # (the serving_trace_overhead_ratio gate)
        self._decode_ticks = 0
        self._last_decode_end_us = 0.0
        # inter-token latency stays O(1) per tick the same way: every
        # token committed in tick t carries tick t's END timestamp, so
        # ONE global ring of tick-end times (written once per tick, not
        # per request) reconstructs any request's per-token gaps at
        # span close from its [t0_tick, t0_tick + ticks) range
        self._tick_ends = [0.0] * _TICK_RING
        # an SLOTracker (observability.slo) the scheduler may attach;
        # fed the tick-granular ITL gaps at request finish
        self.slo = None
        self._h_tick = registry().histogram("serving_tick_ms")
        self._g_occupancy = registry().gauge("serving_batch_occupancy")

    # -- request lifecycle --------------------------------------------------

    def on_submit(self, rid: int, prompt_tokens: int = 0,
                  max_new_tokens: int = 0) -> None:
        now = _now_us()
        with self._lock:
            self._reqs[rid] = {
                "rid": rid, "status": "queued",
                "prompt_tokens": int(prompt_tokens),
                "max_new_tokens": int(max_new_tokens),
                "submit_us": now, "tokens": 0, "ticks": 0,
                "preemptions": 0,
                "phases": [{"phase": "queued", "t0_us": now}],
            }

    def on_prefill(self, rids: Sequence[int], t0_us: float,
                   dur_ms: float) -> None:
        """One packed prefill covered every rid in the admitted batch:
        close each request's wait phase at the prefill start, record the
        shared prefill span, and open the decode span at its end."""
        with self._lock:
            for rid in rids:
                r = self._reqs.get(rid)
                if r is None:
                    continue
                self._close_phase(r, t0_us)
                r["phases"].append({"phase": "prefill", "t0_us": t0_us,
                                    "dur_ms": round(dur_ms, 4)})
                r["phases"].append({"phase": "decode",
                                    "t0_us": t0_us + dur_ms * 1e3,
                                    "t0_tick": self._decode_ticks})
                r["status"] = "running"
            if self._cur is not None:
                self._cur["prefill_ms"] += dur_ms
                self._cur["admitted"] += len(rids)

    def on_decode_tick(self, rids: Sequence[int], t0_us: float,
                       dur_ms: float, tokens: Optional[int] = None,
                       spec_proposed: int = 0,
                       spec_accepted: int = 0) -> None:
        """One bucketed decode step grew every running request by a
        token — or, on a speculative verify tick, by its accepted window
        (``tokens`` = the exact committed count; default one per rid).
        O(1): every open decode span implicitly extends to this step's
        end (ONE span per contiguous decode run — sealed lazily by
        :meth:`_close_phase` against ``_last_decode_end_us``); only the
        tick accumulator is touched here. ``spec_proposed`` /
        ``spec_accepted`` carry the tick's drafted/accepted token counts
        into the tick record (zero on non-speculative ticks)."""
        end_us = t0_us + dur_ms * 1e3
        with self._lock:
            self._tick_ends[self._decode_ticks % _TICK_RING] = end_us
            self._decode_ticks += 1
            if end_us > self._last_decode_end_us:
                self._last_decode_end_us = end_us
            if self._cur is not None:
                self._cur["decode_ms"] += dur_ms
                self._cur["tokens"] += (len(rids) if tokens is None
                                        else int(tokens))
                self._cur["spec_proposed"] += int(spec_proposed)
                self._cur["spec_accepted"] += int(spec_accepted)

    def on_evict(self, rid: int) -> None:
        """Recompute-style preemption: close the decode span and open a
        ``preempted`` span — the visible gap on the request's timeline
        until re-prefill resumes it."""
        now = _now_us()
        with self._lock:
            r = self._reqs.get(rid)
            if r is None:
                return
            self._close_phase(r, now)
            r["phases"].append({"phase": "preempted", "t0_us": now})
            r["status"] = "preempted"
            r["preemptions"] += 1
            if self._cur is not None:
                self._cur["evicted"] += 1

    def on_finish(self, rid: int, latency_ms: Optional[float] = None,
                  ttft_ms: Optional[float] = None,
                  tokens: Optional[int] = None,
                  status: str = "finished",
                  spec_proposed: int = 0,
                  spec_accepted: int = 0) -> None:
        """Close the timeline and emit it as ONE ``request_trace`` JSONL
        event (evicted-then-recomputed requests stay one trace — the
        preemption shows as a phase, never a second trace id).
        ``tokens`` is the scheduler's exact generated-token count; when
        absent the decode-tick total stands in (each tick is one token,
        plus the prefill's TTFT token). ``status`` is the terminal
        outcome — ``finished``, or the robustness layer's ``timeout`` /
        ``error`` / ``cancelled`` — and is carried in the emitted record
        so ``--timeline`` can render a non-success terminal instant."""
        now = _now_us()
        with self._lock:
            r = self._reqs.pop(rid, None)
            if r is None:
                return
            self._close_phase(r, now)
            r["status"] = status
            r["done_us"] = now
            r["tokens"] = (int(tokens) if tokens is not None
                           else min(r["ticks"] + 1, r["max_new_tokens"])
                           if r["max_new_tokens"] else r["ticks"])
            if latency_ms is not None:
                r["latency_ms"] = round(latency_ms, 3)
            if ttft_ms is not None:
                r["ttft_ms"] = round(ttft_ms, 3)
            if spec_proposed:
                # speculative acceptance accounting rides the trace
                # (zero-proposal requests stay schema-compatible)
                r["spec_proposed"] = int(spec_proposed)
                r["spec_accepted"] = int(spec_accepted)
            itl = r.pop("_itl_ms", None)
            if itl:
                r["itl_ms_p50"] = round(nearest_rank(itl, 0.50), 3)
                r["itl_ms_p95"] = round(nearest_rank(itl, 0.95), 3)
            self._finished.append(r)
            if self._cur is not None:
                self._cur["finished"] += 1
            rec = dict(r)   # terminal status rides along
        slo = self.slo
        if slo is not None and itl:
            # outside the tracer lock (the SLO plane has its own); one
            # batched call — per-gap feeds cost a lock + clock read +
            # bucket rotation EACH, which the overhead gate vetoed
            slo.observe_itl_many(itl)
        if sink.enabled():
            sink.emit({"kind": "event", "name": "request_trace", **rec})

    def _close_phase(self, r: Dict[str, Any], end_us: float) -> None:
        """Seal the newest phase if still open (idempotent)."""
        ph = r["phases"][-1]
        if "dur_ms" in ph:
            return
        if ph.get("phase") == "decode":
            # the span ends at the scheduler's last decode-step end, not
            # at whatever host time the closer runs at; its tick count is
            # the global decode-tick delta since the span opened (the
            # request rode every step in between)
            t0_tick = ph.pop("t0_tick", None)
            if t0_tick is not None:
                ph["ticks"] = self._decode_ticks - t0_tick
                r["ticks"] += ph["ticks"]
                # per-token ITL for this span from the global tick-end
                # ring: the token committed in tick i landed at
                # tick_ends[i]; its gap is against the previous tick's
                # end (the span open for the first tick — prefill's
                # token precedes it). Within-span only: a preemption
                # gap is a ``preempted`` phase, not an ITL sample.
                # O(span ticks) once at close, nothing per tick.
                lo = self._decode_ticks - _TICK_RING
                gaps = r.setdefault("_itl_ms", [])
                prev = ph["t0_us"]
                for i in range(t0_tick, self._decode_ticks):
                    if i >= lo:
                        end_i = self._tick_ends[i % _TICK_RING]
                        if end_i >= prev:
                            gaps.append((end_i - prev) / 1e3)
                        prev = end_i
            end = max(self._last_decode_end_us, ph["t0_us"])
        else:
            end = max(end_us, ph["t0_us"])
        ph["dur_ms"] = round((end - ph["t0_us"]) / 1e3, 4)

    # -- tick accounting ----------------------------------------------------

    def begin_tick(self) -> None:
        with self._lock:
            self._cur = {
                "t0_us": _now_us(), "t0": time.perf_counter(),
                "admit_ms": 0.0, "prefill_ms": 0.0, "decode_ms": 0.0,
                "evict_ms": 0.0, "draft_ms": 0.0, "admitted": 0,
                "evicted": 0, "finished": 0, "tokens": 0,
                "spec_proposed": 0, "spec_accepted": 0,
            }

    def acc(self, field: str, dur_ms: float) -> None:
        """Accumulate a wall split (``admit_ms``/``evict_ms``) into the
        open tick."""
        with self._lock:
            if self._cur is not None:
                self._cur[field] += dur_ms

    def end_tick(self, running: int, waiting: int, pages_in_use: int,
                 pages_total: int, max_batch: int) -> None:
        with self._lock:
            cur = self._cur
            if cur is None:
                return
            self._cur = None
            dur_ms = (time.perf_counter() - cur.pop("t0")) * 1e3
            tick = self._tick
            self._tick += 1
            rec = {
                "kind": "tick", "tick": tick,
                "t0_us": round(cur.pop("t0_us"), 1),
                "dur_ms": round(dur_ms, 4),
                "admit_ms": round(cur["admit_ms"], 4),
                "prefill_ms": round(cur["prefill_ms"], 4),
                "decode_ms": round(cur["decode_ms"], 4),
                "evict_ms": round(cur["evict_ms"], 4),
                "draft_ms": round(cur["draft_ms"], 4),
                "admitted": cur["admitted"], "evicted": cur["evicted"],
                "finished": cur["finished"], "tokens": cur["tokens"],
                "spec_proposed": cur["spec_proposed"],
                "spec_accepted": cur["spec_accepted"],
                "running": int(running), "waiting": int(waiting),
                "occupancy": round(running / max_batch, 4)
                if max_batch else 0.0,
                "pages_in_use": int(pages_in_use),
                "pages_total": int(pages_total),
                "page_pool_util": round(pages_in_use / pages_total, 4)
                if pages_total else 0.0,
            }
        self._h_tick.observe(dur_ms)
        self._g_occupancy.set(rec["occupancy"])
        if sink.enabled():
            sink.emit(rec)

    @property
    def tick(self) -> int:
        with self._lock:
            return self._tick

    # -- the in-flight table (HTTP /debug/requests) -------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Deep-copied view of the request table: in-flight requests
        (with their phase timelines so far) + the most recent finished
        ones. Safe to call from any thread at any time."""
        with self._lock:
            def cp(r):
                out = {k: v for k, v in r.items()
                       if k != "phases" and not k.startswith("_")}
                phases, live_ticks = [], r["ticks"]
                for p in r["phases"]:
                    q = dict(p)
                    t0_tick = q.pop("t0_tick", None)
                    if t0_tick is not None and "dur_ms" not in q:
                        # open decode span: its tick count so far
                        q["ticks"] = self._decode_ticks - t0_tick
                        live_ticks += q["ticks"]
                    phases.append(q)
                out["phases"] = phases
                out["ticks"] = live_ticks
                out["phase"] = r["phases"][-1].get("phase")
                return out

            return {
                "tick": self._tick,
                "in_flight": [cp(r) for r in self._reqs.values()],
                "finished_recent": [cp(r) for r in self._finished],
            }
