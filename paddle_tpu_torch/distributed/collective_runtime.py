"""The collective flight recorder and its watchdog, and the axis context
(port of ``paddle_tpu.distributed.collective_runtime``).

Every collective of ``distributed.communication`` (and the consistency
check's digest exchange) runs inside :func:`collective_span`: the
``collective_calls_total{op}`` and ``collective_bytes_total{op}``
counters, a host span ``collective:<op>`` for profiler traces, and a
record in the flight ring. A collective that raises still closes its
span, is recorded with ``status=error`` and bumps
``collective_errors_total{op}``.

Flight recorder: a bounded ring of this process's last N collective
records, ``{seq, op, bytes, t_start, t_end, status}``, ``seq`` counting
up per process. SPMD ranks issue the same sequence of collectives, so
merging the ranks' dumps (``tools/obs_report.py --flight``) finds the
first ``seq`` where they diverge and the ranks that never entered it.
A dump is ``$PADDLE_OBS_DIR/flight/flight-<worker>.json``, written
atomically, in the JAX package's format.

Watchdog: with ``PADDLE_COLLECTIVE_TIMEOUT_S`` > 0 a daemon thread holds
a wall-clock deadline over the collective in flight. When it passes, the
record is marked ``timeout``, the ring is dumped, and a
``dump-request`` marker in the flight directory asks every other rank's
watchdog to dump its ring too: the stalled rank is usually idle between
collectives, and its dump (which never entered the op) is what the merged
report needs.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict, Optional

__all__ = ["FlightRecorder", "flight_recorder", "reset_flight_recorder",
           "collective_span", "AxisContext", "current_axis_context",
           "tensor_nbytes"]

_tls = threading.local()
_OBS = None


def _obs():
    global _OBS
    if _OBS is None:
        from .. import observability

        _OBS = observability
    return _OBS


def tensor_nbytes(x) -> int:
    """Bytes of a tensor or array (0 when unknown)."""
    try:
        return int(x.numel()) * int(x.element_size())
    except AttributeError:
        try:
            return int(x.nbytes)
        except AttributeError:
            return 0


_DUMP_REQUEST = "dump-request"  # the marker peers poll for


class FlightRecorder:
    """A bounded ring of this process's last collective records. Always
    on (an append per collective); the dumps and the watchdog thread run
    only when a flight directory (``$PADDLE_OBS_DIR``) or a timeout
    (``PADDLE_COLLECTIVE_TIMEOUT_S``) is set."""

    def __init__(self, capacity: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 directory: Optional[str] = None, poll_s: float = 0.5):
        if capacity is None:
            capacity = int(os.environ.get("PADDLE_FLIGHT_RING", "128")
                           or 128)
        self.capacity = max(8, capacity)
        if timeout_s is None:
            timeout_s = float(
                os.environ.get("PADDLE_COLLECTIVE_TIMEOUT_S", "0") or 0)
        self.timeout_s = timeout_s
        self._dir_override = directory
        self.poll_s = poll_s
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._in_flight: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # markers older than this process belong to an earlier generation:
        # answering one would overwrite its post-mortem dumps
        self._last_dump_ts = time.time()
        self._timed_out_seq = -1  # the watchdog fired for this seq
        # start the marker poll now: a rank wedged before its first
        # collective must still answer its peers' dump requests
        self._ensure_thread()

    # -- recording -----------------------------------------------------------

    def begin(self, op: str, nbytes: int = 0) -> dict:
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "op": op, "bytes": int(nbytes),
                   "t_start": round(time.time(), 6), "t_end": None,
                   "status": "in_flight"}
            self._ring.append(rec)
            self._in_flight = rec
        self._ensure_thread()
        return rec

    def end(self, rec: dict, status: str = "ok") -> None:
        with self._lock:
            rec["t_end"] = round(time.time(), 6)
            # the watchdog's timeout mark stays the diagnosis: a late
            # success becomes ok_after_timeout, a late error stays timeout
            if rec["status"] == "timeout":
                rec["status"] = ("ok_after_timeout" if status == "ok"
                                 else "timeout")
            else:
                rec["status"] = status
            if self._in_flight is rec:
                self._in_flight = None

    def records(self) -> list:
        with self._lock:
            return [dict(r) for r in self._ring]

    # -- dumps ---------------------------------------------------------------

    def flight_dir(self) -> Optional[str]:
        if self._dir_override:
            return self._dir_override
        obs = os.environ.get("PADDLE_OBS_DIR", "").strip()
        return os.path.join(obs, "flight") if obs else None

    def _worker(self) -> str:
        rank = os.environ.get("PADDLE_TRAINER_ID")
        return f"rank{rank}" if rank is not None else "rank0"

    def dump(self, reason: str) -> Optional[str]:
        """Write this rank's ring to ``<flight_dir>/flight-<worker>.json``
        atomically; None without a directory. Never raises: the dump is
        a best-effort post-mortem of a job that is already failing."""
        d = self.flight_dir()
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            with self._lock:
                payload = {
                    "worker": self._worker(),
                    "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")
                                or 0),
                    # the report keeps only the newest generation's dumps
                    "generation": int(os.environ.get(
                        "PADDLE_RESTART_GENERATION", "0") or 0),
                    "dumped_at": round(time.time(), 6),
                    "reason": reason,
                    "last_seq": self._seq,
                    "records": [dict(r) for r in self._ring],
                }
            path = os.path.join(d, f"flight-{payload['worker']}.json")
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(payload, indent=1))
            os.replace(tmp, path)
            self._last_dump_ts = time.time()
            return path
        except OSError:
            return None

    def request_peer_dumps(self) -> None:
        """Drop the marker every rank's watchdog polls for, so the peers
        dump their rings too."""
        d = self.flight_dir()
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, _DUMP_REQUEST), "w") as f:
                f.write(json.dumps({"ts": round(time.time(), 6),
                                    "from": self._worker()}))
            # our own marker must not re-trigger us (its generic reason
            # would overwrite the precise one just dumped)
            self._last_dump_ts = max(self._last_dump_ts, time.time())
        except OSError:
            pass

    # -- watchdog ------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None or (
                self.timeout_s <= 0 and not self.flight_dir()):
            return
        with self._lock:
            if self._thread is not None:
                return
            t = threading.Thread(target=self._watch, daemon=True,
                                 name="collective-watchdog")
            self._thread = t
        t.start()

    def _watch(self) -> None:
        poll = self.poll_s
        if self.timeout_s > 0:
            poll = min(poll, max(0.05, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            try:
                self._watch_once()
            except Exception:
                pass  # the watchdog must never take the job down

    def _watch_once(self) -> None:
        expired = None
        with self._lock:
            # the deadline check and the mark are one atomic step
            rec = self._in_flight
            if (self.timeout_s > 0 and rec is not None
                    and rec["status"] == "in_flight"
                    and time.time() - rec["t_start"] > self.timeout_s
                    and rec["seq"] > self._timed_out_seq):
                self._timed_out_seq = rec["seq"]
                rec["status"] = "timeout"
                expired = rec
        if expired is not None:
            print(f"[flight-recorder] collective watchdog: op "
                  f"{expired['op']!r} seq {expired['seq']} exceeded "
                  f"{self.timeout_s:.1f}s wall-clock deadline; dumping "
                  "flight ring and requesting peer dumps",
                  file=sys.stderr, flush=True)
            self.dump(reason=f"watchdog: {expired['op']} seq "
                             f"{expired['seq']} exceeded "
                             f"{self.timeout_s:.1f}s")
            self.request_peer_dumps()
        d = self.flight_dir()
        if d:
            try:
                mtime = os.path.getmtime(os.path.join(d, _DUMP_REQUEST))
            except OSError:
                return
            if mtime > self._last_dump_ts:
                self.dump(reason="peer dump request")

    def stop(self) -> None:
        self._stop.set()


_FLIGHT: Optional[FlightRecorder] = None
_FLIGHT_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (created on first use)."""
    global _FLIGHT
    if _FLIGHT is None:
        with _FLIGHT_LOCK:
            if _FLIGHT is None:
                _FLIGHT = FlightRecorder()
    return _FLIGHT


def reset_flight_recorder() -> None:
    """Drop the process-wide recorder, so the next use reads the
    environment again (ring size, timeout, flight directory)."""
    global _FLIGHT
    with _FLIGHT_LOCK:
        if _FLIGHT is not None:
            _FLIGHT.stop()
        _FLIGHT = None


@contextlib.contextmanager
def collective_span(op: str, *tensors):
    """Instrument one collective: the calls and bytes counters, a
    ``collective:<op>`` host span (Communication) and a flight-ring
    record, closed with ``status=error`` (and
    ``collective_errors_total``) when the collective raises."""
    obs = _obs()
    nbytes = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            nbytes += sum(tensor_nbytes(x) for x in t)
        elif t is not None:
            nbytes += tensor_nbytes(t)
    obs.counter("collective_calls_total", op=op).inc()
    if nbytes:
        obs.counter("collective_bytes_total", op=op).inc(nbytes)
    rec = flight_recorder().begin(op, nbytes)
    try:
        with obs.span(f"collective:{op}", event_type="Communication",
                      emit_jsonl=False, op=op):
            yield
    except BaseException:
        obs.counter("collective_errors_total", op=op).inc()
        flight_recorder().end(rec, status="error")
        raise
    else:
        flight_recorder().end(rec, status="ok")


class AxisContext:
    """Maps logical group names (``"data"``, ``"model"``, ``"pipe"``,
    ``"sharding"``) to mesh axis names inside a ``with``."""

    def __init__(self, axes: Dict[str, str]):
        self.axes = dict(axes)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()


def current_axis_context() -> Optional[AxisContext]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None
