"""Per-worker JSONL telemetry sink (port of
``paddle_tpu.observability.sink``; the same record schema, so
``tools/obs_report.py`` reads the port's streams unchanged).

Every record is one JSON object per line in
``$PADDLE_OBS_DIR/metrics-<worker>.jsonl``; workers never share a file,
so multi-process runs need no cross-process locking and
``tools/obs_report.py`` merges by reading the directory. The sink is
*off* unless a directory is configured (``PADDLE_OBS_DIR`` in the env,
the launcher's ``--obs_dir``, or an explicit :func:`configure` call) —
emit() is a single attribute check when disabled, so instrumented code
paths cost nothing in un-observed runs.

Record schema (shared with the reporter):

    {"ts": <unix seconds>, "worker": "rank0", "kind": ..., "name": ...}

kinds:
    step     — per-train-step accounting (step_stats.StepAccounting)
    span     — a timed section: t0_us (unix microseconds) + dur_ms
    event    — a point occurrence (relaunch, rendezvous retry, ...)
    tick     — per-serving-iteration accounting (tracing.ServingTracer)
    snapshot — full metrics-registry dump ({"metrics": [...]})

The file is block-buffered with a time-based flush (at most
``FLUSH_INTERVAL_S`` of records in flight): a line-buffered file costs a
write syscall per record, which on a hot serving loop is the single
largest obs cost (the ``serving_trace_overhead_ratio`` gate). Live
observation goes through the HTTP endpoint, not the file; readers of the
file (obs_report) already tolerate a torn trailing line, so a crash
loses at most the flush window.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = [
    "configure",
    "enabled",
    "emit",
    "flush",
    "flush_metrics",
    "jsonl_path",
    "obs_dir",
    "worker_name",
    "close",
]

ENV_DIR = "PADDLE_OBS_DIR"

#: max seconds an emitted record may sit in the write buffer before a
#: flush is forced (crash-durability bound; see module docstring)
FLUSH_INTERVAL_S = 1.0

# RLock, not Lock: emit() calls jsonl_path() -> _resolve()/worker_name()
# while holding it, and those now lock their own _state mutations (an
# HTTP scrape thread resolves the sink concurrently with the step loop)
_lock = threading.RLock()
_state: Dict[str, Any] = {
    "dir": None,       # resolved output directory or False (disabled)
    "worker": None,
    "file": None,
    "atexit": False,
    "last_flush": 0.0,  # perf_counter of the last forced flush
}


def _default_worker() -> str:
    rank = os.environ.get("PADDLE_TRAINER_ID")
    return f"rank{rank}" if rank is not None else "rank0"


def _resolve() -> Optional[str]:
    """Resolved output dir, or None when the sink is disabled."""
    d = _state["dir"]
    if d is None:  # first touch: consult the environment
        with _lock:
            d = _state["dir"]
            if d is None:
                env = os.environ.get(ENV_DIR, "").strip()
                d = _state["dir"] = env or False
                if _state["worker"] is None:
                    _state["worker"] = _default_worker()
    return d or None


def configure(directory: Optional[str] = None,
              worker: Optional[str] = None) -> None:
    """Point the sink at ``directory`` (None re-reads ``PADDLE_OBS_DIR``;
    an empty string disables). Closes any open file so the next emit
    lands in the new location."""
    with _lock:
        close_locked()
        if directory is None:
            _state["dir"] = None  # re-resolve from env on next use
        else:
            _state["dir"] = directory.strip() or False
        _state["worker"] = worker or None


def enabled() -> bool:
    return _resolve() is not None


def worker_name() -> str:
    if _state["worker"] is None:
        with _lock:
            if _state["worker"] is None:
                _state["worker"] = _default_worker()
    return _state["worker"]


def obs_dir() -> Optional[str]:
    return _resolve()


def jsonl_path() -> Optional[str]:
    d = _resolve()
    if d is None:
        return None
    return os.path.join(d, f"metrics-{worker_name()}.jsonl")


def emit(record: Dict[str, Any]) -> None:
    """Append one record; stamps ``ts``/``worker`` when absent. No-op
    (one dict read) when the sink is disabled."""
    d = _state["dir"]
    if d is False:
        return
    if d is None and _resolve() is None:
        return
    rec = {"ts": round(time.time(), 6), "worker": worker_name()}
    rec.update(record)
    line = json.dumps(rec, separators=(",", ":"), default=_json_default)
    with _lock:
        f = _state["file"]
        if f is None:
            path = jsonl_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # block-buffered: a syscall per line is the dominant obs
            # cost on the serving tick loop (module docstring)
            f = _state["file"] = open(path, "a", buffering=64 * 1024)
            _state["last_flush"] = time.perf_counter()
            if not _state["atexit"]:
                _state["atexit"] = True
                atexit.register(_at_exit)
        f.write(line + "\n")
        now = time.perf_counter()
        if now - _state["last_flush"] >= FLUSH_INTERVAL_S:
            _state["last_flush"] = now
            f.flush()


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def flush_metrics(step: Optional[int] = None) -> None:
    """Emit a full metrics-registry snapshot record (the cumulative
    counters — collective bytes, cache hits — that per-step records
    don't carry)."""
    if not enabled():
        return
    from .metrics import registry

    rec: Dict[str, Any] = {"kind": "snapshot", "metrics": registry().snapshot()}
    if step is not None:
        rec["step"] = int(step)
    emit(rec)


def flush() -> None:
    """Force buffered records to disk (a mid-run reader's hook; emit()
    itself flushes at least every ``FLUSH_INTERVAL_S``)."""
    with _lock:
        f = _state["file"]
        if f is not None:
            _state["last_flush"] = time.perf_counter()
            f.flush()


def _at_exit() -> None:
    try:
        flush_metrics()
    except Exception:
        pass
    close()


def close() -> None:
    with _lock:
        close_locked()


def close_locked() -> None:
    f = _state["file"]
    if f is not None:
        try:
            f.close()
        except Exception:
            pass
        _state["file"] = None
