"""Zero-dep live ops endpoint: stdlib ``http.server`` on a daemon thread
(port of ``paddle_tpu.observability.http_endpoint``).

It makes the run's state pollable live, so a launcher watcher or an
external supervisor (k8s probes, Prometheus scrapers) can ask a running
job "are you healthy, what's in flight, why is p99 climbing" without
tailing files:

- ``/metrics``          — the metrics registry's Prometheus text
  exposition, rendered at scrape time (always-on).
- ``/healthz``          — JSON health: process uptime, heartbeat age
  (``$PADDLE_HEARTBEAT_FILE``), plus whatever the owner's ``health``
  callable reports (trainer: last step, OOM proximity, guard state;
  scheduler: tick, queue depths, page-pool fill). The route is the
  READINESS probe: when the owner reports ``"overloaded": true`` or
  ``"wedged": true`` it replies **503** with the same JSON body so
  balancers stop routing here; ``/healthz?live`` is the LIVENESS split
  — always 200 while the process serves.
- ``/debug/compiles``   — **501**: PyTorch runs eagerly, there is no
  compile to ledger; the JSON body names the slice that brings a
  compile ledger.
- ``/debug/requests``   — the serving tracer's in-flight request table
  (404 when the owner has no request tracer, i.e. a trainer).
- ``/slo``              — the SLO plane's windowed-SLI document
  (``observability.slo``; 404 when no SLOTracker is attached).
  ``/slo?tenant=<name>`` answers the keyed per-tenant view when the
  owner attached one (``slo_tenant``), else the global document.
- ``/dashboard``        — the zero-dep live dashboard: ONE
  self-contained HTML response over the same two snapshots.
- ``/debug/profile?secs=N`` — an on-demand ``torch.profiler`` capture
  (CPU + CUDA activity): blocks ~N seconds on the HTTP thread (the
  serving loop keeps running on its own), writes a Chrome trace under
  the obs dir and returns its path, the count of device kernels it
  holds and its recording ``window`` (``time.time()`` when the profiler
  began and stopped recording). A capture's first launches can lack
  their kernel records, most in a process that has profiled before. So
  on CUDA the window opens only once ``_MARKERS`` marker
  kernels launched inside the recording have run on the card (they take
  that loss, not the caller's work), and no earlier than the first
  launch whose kernel record the trace holds; the reply's ``markers``
  says how many markers the trace holds beside how many were launched. CUPTI records every thread's device activity; the CPU side
  asks for all threads where the installed PyTorch offers it. At most
  ONE capture in flight process-wide (409 while busy), ``secs`` clamped
  to ``_PROFILE_SECS_MAX``, a bad ``secs`` 400.

Security: binds ``127.0.0.1`` by default — the endpoint exposes
internals and lets callers trigger profiler captures, all with no auth,
so exposing it beyond the host is an explicit opt-in
(``host="0.0.0.0"``). ``port=0`` picks an ephemeral port.

Everything served is read through snapshot-style APIs (the registry's
locked ``snapshot()``, the tracer's deep-copied table), so a scrape
mid-step never observes torn state.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from .metrics import registry

__all__ = ["ObsHTTPEndpoint"]

ROUTES = ("/metrics", "/healthz", "/debug/compiles", "/debug/requests",
          "/slo", "/dashboard", "/debug/profile")

_PROFILE_SECS_MAX = 60.0   # an unbounded capture would wedge the thread
_MARKERS = 64              # marker kernels a CUDA capture runs before it opens
_MARKER_KERNEL = "spin_kernel"   # ``torch.cuda._sleep``'s kernel


class ObsHTTPEndpoint:
    """Owns the server thread; ``start()``/``stop()`` bracket it.

    ``health`` and ``requests`` are zero-arg callables returning
    JSON-serializable dicts; they run on the HTTP thread, so they must
    be thread-safe (the tracer and trainer snapshots are).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 requests: Optional[Callable[[], Dict[str, Any]]] = None,
                 slo: Optional[Callable[[], Dict[str, Any]]] = None,
                 slo_tenant: Optional[Callable[[str],
                                               Dict[str, Any]]] = None):
        self._host = host
        self._port = int(port)
        self._health_fn = health
        self._requests_fn = requests
        self._slo_fn = slo
        # keyed per-tenant SLO snapshot (serving/tenancy.py): serves
        # ``/slo?tenant=<name>``; None = tenancy plane off, the query
        # parameter is ignored and /slo answers the global document
        self._slo_tenant_fn = slo_tenant
        # one profiler capture in flight, process-wide state guarded
        # non-blockingly: the busy reply is 409, never a queued wait
        self._profile_lock = threading.Lock()
        # the newest capture's recording window: ``open`` once the
        # profiler records (on CUDA: once its marker kernels have run
        # inside the recording; moved, when the capture ends, to the first
        # launch whose kernel record the trace holds if that came later),
        # ``close`` once it stops (``time.time()``), so a caller can wait
        # until a capture it asked for has begun
        self.profile_window: Dict[str, float] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.time()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ObsHTTPEndpoint":
        if self._server is not None:
            return self
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # no stderr chatter per request
                pass

            def do_GET(self):
                endpoint._handle(self)

        srv = ThreadingHTTPServer((self._host, self._port), Handler)
        srv.daemon_threads = True
        self._server = srv
        self._port = srv.server_address[1]   # resolve port=0
        self._thread = threading.Thread(
            target=srv.serve_forever, name="obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    # -- routes -------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = registry().to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                doc = self._healthz()
                body = _dumps(doc)
                ctype = "application/json"
                qs = h.path.partition("?")[2]
                if ((doc.get("overloaded") or doc.get("wedged"))
                        and "live" not in qs):
                    # readiness split: shedding load or a stalled tick
                    # loop is NOT ready (take it out of rotation) but IS
                    # alive (don't kill it) — liveness opts out via ?live
                    _reply(h, 503, body, ctype)
                    return
            elif path == "/debug/compiles":
                _reply(h, 501, _dumps(
                    {"error": "no compile ledger: PyTorch runs eagerly; "
                              "a ledger comes with the jit slice (ROADMAP "
                              "A.7, jit/)"}), "application/json")
                return
            elif path == "/debug/requests":
                if self._requests_fn is None:
                    _reply(h, 404, _dumps(
                        {"error": "no request tracer attached"}),
                        "application/json")
                    return
                body = _dumps(self._requests_fn())
                ctype = "application/json"
            elif path == "/slo":
                if self._slo_fn is None:
                    _reply(h, 404, _dumps(
                        {"error": "no SLO tracker attached"}),
                        "application/json")
                    return
                tenant = None
                for part in h.path.partition("?")[2].split("&"):
                    if part.startswith("tenant="):
                        tenant = part[len("tenant="):]
                if tenant and self._slo_tenant_fn is not None:
                    body = _dumps(self._slo_tenant_fn(tenant))
                else:
                    body = _dumps(self._slo_fn())
                ctype = "application/json"
            elif path == "/dashboard":
                from .slo import render_dashboard
                slo_doc = self._slo_fn() if self._slo_fn else None
                health_doc = (self._health_fn()
                              if self._health_fn else None)
                body = render_dashboard(slo_doc, health_doc).encode()
                ctype = "text/html; charset=utf-8"
            elif path == "/debug/profile":
                code, doc = self._profile(h.path.partition("?")[2])
                _reply(h, code, _dumps(doc), "application/json")
                return
            else:
                _reply(h, 404, _dumps(
                    {"error": f"unknown route {path}",
                     "routes": list(ROUTES)}), "application/json")
                return
        except Exception as exc:   # a broken provider must not kill scrapes
            _reply(h, 500, _dumps({"error": f"{type(exc).__name__}: {exc}"}),
                   "application/json")
            return
        _reply(h, 200, body, ctype)

    def _profile(self, qs: str) -> tuple:
        """``/debug/profile?secs=N``: one on-demand ``torch.profiler``
        capture. Runs ON the handler thread (ThreadingHTTPServer — other
        scrapes keep answering), bounded to ``_PROFILE_SECS_MAX``; the
        Chrome trace lands under the obs dir when the sink is
        configured, else a tempdir. 409 while another capture runs."""
        secs = 1.0
        for part in qs.split("&"):
            if part.startswith("secs="):
                try:
                    secs = float(part[5:])
                except ValueError:
                    return 400, {"error": f"bad secs={part[5:]!r}"}
        secs = min(max(secs, 0.05), _PROFILE_SECS_MAX)
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"error": "a profiler capture is already in "
                                  "flight; retry when it finishes"}
        try:
            import tempfile

            from . import sink
            base = sink.obs_dir()
            if base:
                out = os.path.join(base, "profile")
            else:
                out = os.path.join(tempfile.gettempdir(),
                                   "paddle_tpu_torch_profile")
            os.makedirs(out, exist_ok=True)
            path = os.path.join(
                out, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
            window = self.profile_window = {}
            kernels, markers = _capture(secs, path, window)
            return 200, {"status": "ok", "secs": secs, "path": path,
                         "device_kernels": kernels, "markers": markers,
                         "window": [window["open"], window["close"]]}
        finally:
            self._profile_lock.release()

    def _healthz(self) -> Dict[str, Any]:
        now = time.time()
        out: Dict[str, Any] = {
            "status": "ok",
            "uptime_s": round(now - self._t_start, 3),
            "pid": os.getpid(),
        }
        hb_path = os.environ.get("PADDLE_HEARTBEAT_FILE")
        if hb_path:
            out["heartbeat"] = _heartbeat(hb_path, now)
        if self._health_fn is not None:
            out.update(self._health_fn())
        return out


def _heartbeat(path: str, now: float) -> Dict[str, Any]:
    """Heartbeat-file age: mtime works for plain-touch beats, the JSON
    body adds the last completed step for enriched ones (watcher.py)."""
    try:
        age_s = round(now - os.stat(path).st_mtime, 3)
    except OSError:
        return {"present": False}
    out: Dict[str, Any] = {"present": True, "age_s": age_s}
    from ..distributed.launch.watcher import read_heartbeat

    beat = read_heartbeat(path)
    if beat:
        out.update({k: beat[k] for k in ("step", "step_ms") if k in beat})
    return out


def _capture(secs: float, path: str, window: Dict[str, float]) -> tuple:
    """``torch.profiler`` over ``secs`` seconds of whatever the process
    runs (CPU and, where CUDA is there, CUDA activity); writes the Chrome
    trace to ``path`` and returns the device kernels it holds and
    ``[recorded, launched]`` of its marker kernels. ``window`` gets the
    wall times the recording began (``open``; a first capture in a
    process starts CUPTI, which takes seconds; on CUDA, once the
    ``_MARKERS`` marker kernels launched after the profiler started have
    finished on the card, and no earlier than the first launch the trace
    holds a kernel record for) and ended (``close``). Where the
    installed PyTorch offers them, every thread's CPU ops are recorded
    and the exit skips building Python events (the trace file is all
    that is read), so the capture holds the GIL as little as it can."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        for opts in ({"profile_all_threads": True, "trace_only": True},
                     {"profile_all_threads": True}):
            try:
                kw["experimental_config"] = _ExperimentalConfig(**opts)
                break
            except TypeError:
                continue
    except ImportError:
        pass    # an older PyTorch: the CPU side sees this thread only
    launched = _MARKERS if cuda else 0
    with profile(activities=acts, **kw) as prof:
        if launched:
            # on a stream of this thread's own, so the wait is for the
            # markers alone and not for the work the process queued
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(launched):
                    torch.cuda._sleep(1000)
            stream.synchronize()
        window["open"] = time.time()
        time.sleep(secs)
        window["close"] = time.time()
    prof.export_chrome_trace(path)
    kernels, markers = _read_trace(path, window)
    return kernels, [markers, launched]


def _read_trace(path: str, window: Dict[str, float]) -> tuple:
    """A Chrome trace's device kernels and the marker kernels among them;
    moves ``window["open"]`` to the first launch whose kernel record the
    trace holds where that came later (the trace's times are
    microseconds past ``baseTimeNanoseconds``, a wall time)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    first = min((e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("args", {}).get("correlation") in recorded),
                default=None)
    if first is not None:
        window["open"] = max(window["open"], doc.get(
            "baseTimeNanoseconds", 0) / 1e9 + first / 1e6)
    return len(kernels), sum(1 for e in kernels
                             if _MARKER_KERNEL in e.get("name", ""))


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, default=str).encode()


def _reply(h: BaseHTTPRequestHandler, code: int, body: bytes,
           ctype: str) -> None:
    try:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass   # scraper went away mid-reply; nothing to salvage
