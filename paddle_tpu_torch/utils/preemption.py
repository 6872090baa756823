"""Preemption-aware graceful shutdown (port of
``paddle_tpu.utils.preemption``).

A preempted job gets a SIGTERM with a short grace window. The difference
between losing every step since the last periodic save and losing none
is whether the trainer notices the signal at a step boundary and writes
a just-in-time checkpoint before the SIGKILL lands.

This module is the notice half:

- :class:`PreemptionGuard` latches SIGTERM/SIGUSR1 into a thread-safe
  flag the trainer polls at step boundaries; the previous handler is
  chained, not clobbered.
- ``PADDLE_FI_PREEMPT_AT_STEP`` is the drill hook: the guard delivers a
  REAL ``SIGTERM`` to its own process at the armed step boundary (once
  per drill, marker-file guarded), so drills exercise the actual signal
  path.
- :data:`PREEMPTED_EXIT_CODE` (118, the JAX package's value) is the exit
  status of a graceful preemption shutdown, which an elastic launcher
  relaunches at once without spending restart budget.
- :class:`TrainingPreempted` subclasses ``SystemExit`` with that code: a
  training script that lets it propagate exits with the right status.

The consume half is ``parallel.hybrid.HybridParallelTrainer``
(``enable_preemption_guard`` and the step-boundary check).
"""
from __future__ import annotations

import os
import signal
import sys
import threading

__all__ = ["PREEMPTED_EXIT_CODE", "PreemptionGuard", "TrainingPreempted"]

# the JAX package's value, which its elastic watcher classifies as a
# preemption; the tests hold the two equal
PREEMPTED_EXIT_CODE = 118


class TrainingPreempted(SystemExit):
    """The trainer noticed a preemption notice at a step boundary and
    wrote a just-in-time full-TrainState checkpoint. Subclasses
    ``SystemExit`` with :data:`PREEMPTED_EXIT_CODE`, so letting it
    propagate exits the process with the status the elastic watcher
    classifies as ``preemption`` (immediate relaunch, no backoff)."""

    def __init__(self, msg: str, step: int | None = None,
                 checkpoint_path: str | None = None, loss=None):
        super().__init__(PREEMPTED_EXIT_CODE)
        self.msg = msg
        self.step = step
        self.checkpoint_path = checkpoint_path
        # the completed step's loss: the raise happens inside step(), so
        # without this the caller could never log its final step
        self.loss = loss

    def __str__(self):
        return self.msg


class PreemptionGuard:
    """Latch preemption signals for step-boundary consumption.

    Usage (what ``HybridParallelTrainer.enable_preemption_guard`` does):

        guard = PreemptionGuard()          # installs handlers
        ...
        if guard.preemption_noticed(completed_step=step):
            # flush async saves, write JIT checkpoint, exit 118

    Signal handlers can only be installed from the main thread; off the
    main thread the guard still works for fault-injected and
    :meth:`notify` -triggered preemption, and says so on stderr rather
    than failing.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1),
                 install: bool = True):
        self._event = threading.Event()
        self._signals = tuple(signals)
        self._prev_handlers: dict = {}
        self._installed = False
        self._why: str | None = None
        if install:
            self.install()

    # -- signal plumbing -----------------------------------------------------

    def install(self) -> bool:
        """Install the latching handlers (chaining any previous callable
        handler). Returns True when installed."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            print("[preemption] WARNING: not on the main thread — signal "
                  "handlers not installed; only injected/programmatic "
                  "preemption will be noticed", file=sys.stderr)
            return False
        for sig in self._signals:
            self._prev_handlers[sig] = signal.signal(
                sig, self._make_handler(sig))
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _make_handler(self, sig):
        def handler(signum, frame):
            self.notify(f"signal {signal.Signals(signum).name}")
            # resolved at delivery time: install() stores the previous
            # handler AFTER _make_handler runs, so binding it at make
            # time would always chain to None
            prev = self._prev_handlers.get(sig)
            if callable(prev) and prev not in (
                    signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)

        return handler

    # -- notice --------------------------------------------------------------

    def notify(self, why: str = "programmatic") -> None:
        """Latch a preemption notice (signal handler / tests / an
        external cluster-notice poller)."""
        if not self._event.is_set():
            self._why = why
            print(f"[preemption] notice received ({why}): will checkpoint "
                  "and exit at the next step boundary", file=sys.stderr,
                  flush=True)
        self._event.set()

    @property
    def why(self) -> str | None:
        return self._why

    def preemption_noticed(self, completed_step: int | None = None) -> bool:
        """The step-boundary poll. Consults the fault-injection point
        first (which delivers a real SIGTERM to this process at the
        armed step), then the latched flag."""
        if completed_step is not None:
            self._maybe_inject(int(completed_step))
        return self._event.is_set()

    def _maybe_inject(self, step: int) -> None:
        from . import fault_injection as fi

        if not fi.preempt_at_step(step):
            return
        if not self._installed:
            # no handler to catch it: a self-SIGTERM would hit the
            # default disposition and kill the process outright — latch
            # directly instead, which is the notice the drill wants
            self.notify(f"fault injection at step {step} "
                        "(no signal handler)")
            return
        os.kill(os.getpid(), signal.SIGTERM)
        # a self-delivered signal is handled "soon" (between bytecodes),
        # not synchronously — wait for the latch so the boundary that
        # armed the drill is deterministically the one that notices
        if not self._event.wait(timeout=5.0):
            self.notify(f"fault injection at step {step} "
                        "(signal latch timed out)")
