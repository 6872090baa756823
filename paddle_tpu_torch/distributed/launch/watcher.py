"""The launcher's watcher (port of
``paddle_tpu.distributed.launch.watcher``): classify how the ranks of a
pod die, and drive the relaunch decision. Standard library only, as the
JAX package's: the launcher is a supervisor and imports no model code.

Six classes:

- ``clean``: every rank exited 0, the job is done;
- ``crash``: a rank exited nonzero or died on a signal (SIGKILL, a
  segfault, a preemption that outran its grace window): relaunch with
  backoff under the restart budget;
- ``divergence``: a rank exited :data:`DIVERGENCE_EXIT_CODE` (117, the
  trainer's ``NumericalDivergenceError``, after its rollback): relaunched
  as a crash, classified apart;
- ``preemption``: EVERY failed rank exited :data:`PREEMPTED_EXIT_CODE`
  (118: the trainer noticed SIGTERM/SIGUSR1 at a step boundary and wrote
  a just-in-time checkpoint): relaunched at once, costing no budget;
- ``desync``: a rank exited :data:`DESYNC_EXIT_CODE` (119, the periodic
  consistency check found ranks disagreeing): a full restart of every
  rank from the newest common checkpoint, never a resume in place;
- ``hang``: ranks alive but their heartbeat files stale.

Mixed exits classify by severity: desync > divergence > preemption (all
failed ranks 118) > crash. Sibling ranks die within milliseconds of each
other (a SIGKILLed rank's peers fail in their next collective), so
``settle_s`` holds the classification while ranks are still alive for up
to that long. Failures are classified before hangs: a rank blocked on a
dead peer never reads as hung before the death is seen.

Heartbeats are files: each rank gets ``PADDLE_HEARTBEAT_FILE`` and
touches it (:func:`touch_heartbeat`, which the trainer's step accounting
calls with the step and its rolling step time). A rank that never
creates its file is exempt from hang detection. With step-enriched beats
the watcher flags stragglers: a rank whose step time exceeds
``straggler_ratio`` x the other ranks' median for ``straggler_windows``
heartbeat updates in a row (a ``straggler`` event, never a relaunch).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal as _signal
import sys
import time
from statistics import median as _median

__all__ = ["DESYNC_EXIT_CODE", "DIVERGENCE_EXIT_CODE",
           "PREEMPTED_EXIT_CODE", "ExitKind", "WatchEvent", "Watcher",
           "touch_heartbeat", "read_heartbeat"]

# the trainer's exit codes, by value (tests hold them equal to
# parallel.hybrid's, utils.preemption's and distributed.consistency's)
DIVERGENCE_EXIT_CODE = 117
PREEMPTED_EXIT_CODE = 118
DESYNC_EXIT_CODE = 119


class ExitKind:
    CLEAN = "clean"
    CRASH = "crash"
    DIVERGENCE = "divergence"
    PREEMPTION = "preemption"
    DESYNC = "desync"
    HANG = "hang"


@dataclasses.dataclass
class WatchEvent:
    kind: str        # ExitKind.*
    ranks: list      # local ranks implicated
    detail: str      # the diagnosis (exit codes, signal names)


def _describe_rc(rc) -> str:
    if rc is None:
        return "running"
    if rc < 0:
        try:
            name = _signal.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        return f"killed by {name}"
    if rc == DIVERGENCE_EXIT_CODE:
        return (f"numerical divergence (NumericalDivergenceError, "
                f"exit {rc}: consecutive-skip budget exhausted; the "
                "trainer rolled back to the newest valid checkpoint if "
                "one was available)")
    if rc == PREEMPTED_EXIT_CODE:
        return (f"preempted (graceful shutdown, exit {rc}: the trainer "
                "noticed SIGTERM/SIGUSR1 at a step boundary and wrote a "
                "just-in-time checkpoint before exiting)")
    if rc == DESYNC_EXIT_CODE:
        return (f"cross-rank desync (DesyncError, exit {rc}: the "
                "periodic consistency check found ranks disagreeing on "
                "replicated state; restart ALL ranks from the newest "
                "common checkpoint — never resume in place)")
    return f"exit code {rc}"


def touch_heartbeat(path: str | None = None, step: int | None = None,
                    step_ms: float | None = None) -> None:
    """Refresh this rank's heartbeat file (default
    ``$PADDLE_HEARTBEAT_FILE``; a no-op when unset). With ``step`` the
    file holds ``{"step", "ts"[, "step_ms"]}``, so a hang diagnosis names
    the last completed step and the straggler check reads the step time;
    without it the file is only touched."""
    path = path or os.environ.get("PADDLE_HEARTBEAT_FILE")
    if not path:
        return
    if step is None:
        with open(path, "a"):
            os.utime(path, None)
        return
    # one small write: a concurrent reader sees at worst a torn line,
    # which read_heartbeat treats as "no step info"
    beat = {"step": int(step), "ts": round(time.time(), 3)}
    if step_ms is not None:
        beat["step_ms"] = round(float(step_ms), 3)
    with open(path, "w") as f:
        f.write(json.dumps(beat))


def read_heartbeat(path: str) -> dict | None:
    """An enriched heartbeat file's content; None for plain-touch beats,
    missing files and torn writes."""
    try:
        with open(path) as f:
            data = json.loads(f.read())
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


class Watcher:
    """Polls a pod's subprocesses (``pod.procs``, each with ``poll()``)
    and classifies how they die. Synchronous (:meth:`scan`): the
    launcher's control loop drives it, so the relaunch decisions stay
    deterministic."""

    def __init__(self, pod, hang_timeout_s: float = 0.0,
                 heartbeat_paths: list | None = None,
                 elastic_manager=None, straggler_ratio: float = 0.0,
                 straggler_windows: int = 3, obs_event=None,
                 settle_s: float = 0.0):
        self.pod = pod
        self.hang_timeout_s = hang_timeout_s
        self.heartbeat_paths = heartbeat_paths or []
        self.elastic = elastic_manager
        self.settle_s = float(settle_s)
        self._first_failure_ts: float | None = None
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_windows = max(1, int(straggler_windows))
        self.obs_event = obs_event  # callable(name, **fields) or None
        self._straggle_counts: dict = {}   # rank -> windows in a row
        self._straggle_flagged: set = set()
        self._last_beat_steps: dict = {}   # rank -> last step evaluated

    def scan(self) -> WatchEvent | None:
        """One classification pass; None while everything looks healthy
        (or while a failure settles)."""
        rcs = [p.poll() for p in self.pod.procs]
        failed = [i for i, rc in enumerate(rcs) if rc is not None and rc != 0]
        if failed:
            if self.settle_s > 0 and any(rc is None for rc in rcs):
                now = time.time()
                if self._first_failure_ts is None:
                    self._first_failure_ts = now
                if now - self._first_failure_ts < self.settle_s:
                    return None  # let the dying peers finish exiting
            self._first_failure_ts = None
            detail = ", ".join(
                f"rank {i}: {_describe_rc(rcs[i])}" for i in failed)
            if any(rcs[i] == DESYNC_EXIT_CODE for i in failed):
                kind = ExitKind.DESYNC
            elif any(rcs[i] == DIVERGENCE_EXIT_CODE for i in failed):
                kind = ExitKind.DIVERGENCE
            elif all(rcs[i] == PREEMPTED_EXIT_CODE for i in failed):
                # only when EVERY failed rank shut down gracefully: a mix
                # with a real crash costs budget like a crash
                kind = ExitKind.PREEMPTION
            else:
                kind = ExitKind.CRASH
            return WatchEvent(kind, failed, detail)
        if rcs and all(rc == 0 for rc in rcs):
            return WatchEvent(ExitKind.CLEAN, list(range(len(rcs))),
                              "all ranks exited 0")
        self._check_stragglers(rcs)
        hung = self._hung_ranks(rcs)
        if hung:
            parts = []
            for i in hung:
                msg = f"rank {i}: heartbeat stale > {self.hang_timeout_s:.1f}s"
                hb = (read_heartbeat(self.heartbeat_paths[i])
                      if i < len(self.heartbeat_paths) else None)
                if hb is not None and "step" in hb:
                    msg += f", last step {hb['step']}"
                parts.append(msg)
            detail = ", ".join(parts)
            if self.elastic is not None:
                dead = self.elastic.dead_nodes()
                if dead:
                    detail += f"; elastic dead nodes: {dead}"
            return WatchEvent(ExitKind.HANG, hung, detail)
        return None

    def _check_stragglers(self, rcs) -> None:
        """Each alive rank's rolling step time against the other ranks'
        median; one ``straggler`` event per trip, re-armed on recovery.
        A window is one heartbeat update (the rank's step advanced), so
        the scan rate does not inflate the count."""
        if self.straggler_ratio <= 0 or len(self.heartbeat_paths) < 2:
            return
        beats = {}
        for i, path in enumerate(self.heartbeat_paths):
            if i < len(rcs) and rcs[i] is not None:
                continue  # exited ranks are not stragglers
            hb = read_heartbeat(path)
            if hb is not None and "step_ms" in hb and "step" in hb:
                beats[i] = hb
        if len(beats) < 2:
            return
        for rank, hb in beats.items():
            if hb["step"] == self._last_beat_steps.get(rank):
                continue  # no new window for this rank yet
            self._last_beat_steps[rank] = hb["step"]
            # the OTHER ranks' median: with the suspect's own time in it
            # a 2-rank straggler could never cross a ratio >= 2
            median = _median([b["step_ms"] for r2, b in beats.items()
                              if r2 != rank])
            if median <= 0:
                continue
            if hb["step_ms"] > self.straggler_ratio * median:
                count = self._straggle_counts.get(rank, 0) + 1
                self._straggle_counts[rank] = count
                if (count >= self.straggler_windows
                        and rank not in self._straggle_flagged):
                    self._straggle_flagged.add(rank)
                    print(f"[watcher] straggler: rank {rank} step time "
                          f"{hb['step_ms']:.1f}ms > {self.straggler_ratio}x "
                          f"median {median:.1f}ms for {count} consecutive "
                          f"windows (last step {hb['step']})",
                          file=sys.stderr, flush=True)
                    if self.obs_event is not None:
                        self.obs_event(
                            "straggler", rank=rank, step=int(hb["step"]),
                            step_ms=float(hb["step_ms"]),
                            median_ms=round(median, 3),
                            ratio=self.straggler_ratio, windows=count)
            else:
                self._straggle_counts[rank] = 0
                self._straggle_flagged.discard(rank)

    def reset_straggler_state(self) -> None:
        """Forget the per-rank straggler history and the settle clock
        (the launcher calls it at every pod start: a new generation's
        steps repeat the old one's numbers after a rollback)."""
        self._straggle_counts.clear()
        self._straggle_flagged.clear()
        self._last_beat_steps.clear()
        self._first_failure_ts = None

    def _hung_ranks(self, rcs) -> list:
        if self.hang_timeout_s <= 0:
            return []
        now = time.time()
        hung = []
        for i, path in enumerate(self.heartbeat_paths):
            if i >= len(rcs) or rcs[i] is not None:
                continue  # exited: the crash/clean logic owns it
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue  # never opted in to heartbeating
            if age > self.hang_timeout_s:
                hung.append(i)
        return hung
