"""Fault injection for drills (port of ``paddle_tpu.utils.fault_injection``):
the numerical-anomaly and preemption points of training, and the
serving, router and handoff points of the replica fleet.

``PADDLE_FI_NAN_AT_STEP`` names the trainer steps whose loss is
multiplied by NaN, poisoning the loss and, through the chain rule, every
grad; the anomaly guard must then skip the step. Grammar: ``"7"`` fires
at step 7 only, ``"7+"`` at 7 and every later step, and comma lists
combine.

``PADDLE_FI_PREEMPT_AT_STEP`` (one integer step) makes
``preempt_at_step`` answer True once, at the boundary after that step:
the ``PreemptionGuard`` then sends a real SIGTERM to its own process.
It needs ``PADDLE_FI_DIR``, where a marker file remembers the firing
across the relaunch (which inherits the environment); without it the
point is ignored, loudly.

The launcher's points, each firing on the rank ``PADDLE_FI_KILL_RANK``
names (default 0; the rank is ``PADDLE_TRAINER_ID``) and once per drill
through a marker in ``PADDLE_FI_DIR``, so a relaunched generation does
not fire it again: ``PADDLE_FI_KILL_AT_STEP`` (``at_step`` SIGKILLs the
process), ``PADDLE_FI_DESYNC_AT_STEP`` (``desync_at_step``: the trainer
perturbs this rank's params) and ``PADDLE_FI_STALL_AT_STEP``
(``stall_at_step``: the trainer sleeps ``PADDLE_FI_STALL_SECS``, default
30, mid-step); the preemption point is rank-filtered the same way.
``PADDLE_FI_DELAY_HEARTBEAT_S`` stalls the elastic manager's heartbeat
(``heartbeat_delay``), and ``PADDLE_FI_FAIL_RENDEZVOUS_N`` fails the
launcher's first N rendezvous attempts (``rendezvous``, counted in
``PADDLE_FI_DIR``).

The serving points (``PADDLE_FI_SERVE_NAN_AT_TICK``,
``PADDLE_FI_SERVE_SLOW_TICK``, ``PADDLE_FI_SERVE_POOL_PRESSURE``) poison
one request's decode logits, stretch a decode tick or reserve KV pages;
the router points (``PADDLE_FI_ROUTER_KILL_REPLICA``,
``PADDLE_FI_ROUTER_WEDGE_REPLICA``, spec ``"name:tick[:secs]"``) crash or
wedge one fleet member once; the handoff points
(``PADDLE_FI_HANDOFF_DROP``, ``PADDLE_FI_HANDOFF_PARTIAL``,
``PADDLE_FI_HANDOFF_STALL``) lose, truncate or hold a disaggregated KV
transfer. Every fleet replica shares the process environment, so the
per-tick serving and handoff specs take an optional ``"name@"`` prefix
that restricts them to one replica (the scheduler's ``fi_scope``); an
unscoped spec fires everywhere. :func:`armed` says whether a point is
armed at all, so hot loops resolve it once.

Two helpers act directly, for the checkpoint and batch drills:
:func:`corrupt_checkpoint` damages a committed checkpoint's files (a
flipped byte, a truncated shard, a lost ``meta.json``) so its integrity
checks must catch it, and :func:`poison_nan` plants a NaN in a copy of a
floating-point array.
"""
from __future__ import annotations

import os
import signal
import sys
import time

__all__ = ["armed", "nan_at_step", "preempt_at_step", "at_step",
           "desync_at_step", "stall_at_step", "heartbeat_delay",
           "rendezvous", "serve_nan_at_tick",
           "serve_slow_tick", "serve_pool_pressure", "router_kill_replica",
           "router_wedge_replica", "handoff_drop", "handoff_partial",
           "handoff_stall", "poison_nan", "corrupt_checkpoint"]

_ENV = {
    "nan_at_step": "PADDLE_FI_NAN_AT_STEP",
    "preempt_at_step": "PADDLE_FI_PREEMPT_AT_STEP",
    "at_step": "PADDLE_FI_KILL_AT_STEP",
    "desync_at_step": "PADDLE_FI_DESYNC_AT_STEP",
    "stall_at_step": "PADDLE_FI_STALL_AT_STEP",
    "heartbeat_delay": "PADDLE_FI_DELAY_HEARTBEAT_S",
    "rendezvous": "PADDLE_FI_FAIL_RENDEZVOUS_N",
    "serve_nan_at_tick": "PADDLE_FI_SERVE_NAN_AT_TICK",
    "serve_slow_tick": "PADDLE_FI_SERVE_SLOW_TICK",
    "serve_pool_pressure": "PADDLE_FI_SERVE_POOL_PRESSURE",
    "router_kill_replica": "PADDLE_FI_ROUTER_KILL_REPLICA",
    "router_wedge_replica": "PADDLE_FI_ROUTER_WEDGE_REPLICA",
    "handoff_drop": "PADDLE_FI_HANDOFF_DROP",
    "handoff_partial": "PADDLE_FI_HANDOFF_PARTIAL",
    "handoff_stall": "PADDLE_FI_HANDOFF_STALL",
}

# specs already warned about (preempt_at_step is consulted every step)
_WARNED_MALFORMED_PREEMPT: set = set()


def _fi_dir() -> str | None:
    d = os.environ.get("PADDLE_FI_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
    return d or None


def _fire_once(marker: str) -> bool:
    """Atomically claim a fire-once marker; True exactly once per drill
    (across processes and restarts: O_EXCL in ``PADDLE_FI_DIR``)."""
    d = _fi_dir()
    if d is None:
        return True  # no dir -> no cross-restart memory; caller beware
    try:
        fd = os.open(os.path.join(d, marker),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def poison_nan(arr, index: int = 0):
    """Batch-poisoning helper for drills whose inputs are floating
    point: returns a numpy copy with one NaN planted at flat ``index``.
    (Token models poison through the trainer's loss multiplier instead:
    int batches cannot carry a NaN.)"""
    import numpy as np

    out = np.array(arr, copy=True)
    if not np.issubdtype(out.dtype, np.floating):
        raise TypeError(
            f"cannot plant NaN in dtype {out.dtype}: poison the loss/grads "
            "via PADDLE_FI_NAN_AT_STEP instead")
    out.flat[index] = np.nan
    return out


def corrupt_checkpoint(path: str, mode: str = "flip",
                       target: str | None = None) -> str:
    """Damage a committed checkpoint so integrity verification must catch
    it. Modes: ``flip`` (xor the middle byte of a file: a CRC mismatch),
    ``truncate`` (drop the second half: a size mismatch), ``drop_meta``
    (delete ``meta.json``). ``target`` names the file (default: the first
    ``shard-*`` file). Returns the damaged file's path."""
    if mode == "drop_meta":
        victim = os.path.join(path, "meta.json")
        os.remove(victim)
        return victim
    if target is None:
        shards = sorted(n for n in os.listdir(path) if n.startswith("shard-"))
        if not shards:
            raise FileNotFoundError(f"no shard files under {path!r}")
        target = shards[0]
    victim = os.path.join(path, target)
    size = os.path.getsize(victim)
    if mode == "flip":
        with open(victim, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    elif mode == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return victim


def armed(point: str) -> bool:
    """Is an injection point armed in this process's environment?"""
    return bool(os.environ.get(_ENV[point]))


def nan_at_step(step: int) -> bool:
    """Should ``step`` be poisoned with NaN?"""
    spec = os.environ.get("PADDLE_FI_NAN_AT_STEP")
    if not spec:
        return False
    step = int(step)
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.endswith("+"):
            if step >= int(part[:-1]):
                return True
        elif int(part) == step:
            return True
    return False


def _warn_preempt_once(target: str, msg: str) -> None:
    if target not in _WARNED_MALFORMED_PREEMPT:
        _WARNED_MALFORMED_PREEMPT.add(target)
        print(msg, file=sys.stderr)


def preempt_at_step(step: int) -> bool:
    """Should the guard send a SIGTERM to this process at the boundary
    after ``step``? Fires once per drill (a marker in ``PADDLE_FI_DIR``
    keeps the relaunched worker from preempting again)."""
    target = os.environ.get("PADDLE_FI_PREEMPT_AT_STEP")
    if not target:
        return False
    try:
        target_step = int(target)
    except ValueError:
        _warn_preempt_once(target, "[fault-injection] ignoring malformed "
                           f"PADDLE_FI_PREEMPT_AT_STEP={target!r} (expected "
                           "a single integer step)")
        return False
    if target_step != int(step) or not _rank_targeted():
        return False
    if _fi_dir() is None:
        # without the marker dir every relaunched generation would
        # re-preempt at the same boundary, forever
        _warn_preempt_once(target, "[fault-injection] ignoring "
                           "PADDLE_FI_PREEMPT_AT_STEP: PADDLE_FI_DIR is "
                           "required for its fire-once marker")
        return False
    rank = _rank()
    if not _fire_once(f"preempt_at_step-{target}-rank{rank}"):
        return False
    print(f"[fault-injection] SIGTERM (preemption notice) rank {rank} "
          f"at step {step}", file=sys.stderr, flush=True)
    return True


def _rank() -> str:
    return os.environ.get("PADDLE_TRAINER_ID", "0")


def _rank_targeted() -> bool:
    """Is this process the rank ``PADDLE_FI_KILL_RANK`` names (default
    0)?"""
    return _rank() == os.environ.get("PADDLE_FI_KILL_RANK", "0")


def at_step(step: int) -> None:
    """A training loop's point: SIGKILL this process when the armed step
    is reached (once per drill, on the targeted rank)."""
    target = os.environ.get("PADDLE_FI_KILL_AT_STEP")
    if not target or int(target) != int(step) or not _rank_targeted():
        return
    rank = _rank()
    if not _fire_once(f"kill_at_step-{target}-rank{rank}"):
        return
    print(f"[fault-injection] SIGKILL rank {rank} at step {step}",
          file=sys.stderr, flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def desync_at_step(step: int) -> bool:
    """Should this rank's params be perturbed after ``step``? Once, on
    the targeted rank only: its peers keep the clean state, so the next
    consistency digest disagrees and names this rank."""
    target = os.environ.get("PADDLE_FI_DESYNC_AT_STEP")
    if not target or int(target) != int(step) or not _rank_targeted():
        return False
    rank = _rank()
    if not _fire_once(f"desync_at_step-{target}-rank{rank}"):
        return False
    print(f"[fault-injection] perturbing params on rank {rank} at step "
          f"{step} (desync drill)", file=sys.stderr, flush=True)
    return True


def stall_at_step(step: int) -> float:
    """Seconds this rank should sleep mid-step (0.0 when not armed, not
    this step or not this rank); once. Its peers then block in their next
    collective: the watchdog and flight-recorder drill."""
    target = os.environ.get("PADDLE_FI_STALL_AT_STEP")
    if not target or int(target) != int(step) or not _rank_targeted():
        return 0.0
    rank = _rank()
    if not _fire_once(f"stall_at_step-{target}-rank{rank}"):
        return 0.0
    secs = float(os.environ.get("PADDLE_FI_STALL_SECS", "30") or 30)
    print(f"[fault-injection] stalling rank {rank} for {secs:.1f}s at "
          f"step {step}", file=sys.stderr, flush=True)
    return secs


def heartbeat_delay() -> None:
    """The elastic heartbeat's point: stall the beat (a hung node)."""
    s = os.environ.get("PADDLE_FI_DELAY_HEARTBEAT_S")
    if s:
        time.sleep(float(s))


def rendezvous() -> None:
    """The launcher's rendezvous point: raise ``ConnectionError`` on the
    first N consultations (``PADDLE_FI_FAIL_RENDEZVOUS_N``, counted by
    marker files so retries across processes share the budget)."""
    n = os.environ.get("PADDLE_FI_FAIL_RENDEZVOUS_N")
    if not n:
        return
    if _fi_dir() is None:
        # ValueError: a misconfigured drill must not be retried away
        raise ValueError(
            "PADDLE_FI_FAIL_RENDEZVOUS_N requires PADDLE_FI_DIR for the "
            "attempt counter")
    for attempt in range(int(n)):
        if _fire_once(f"rendezvous_fail-{attempt}"):
            print(f"[fault-injection] failing rendezvous attempt "
                  f"{attempt + 1}/{n}", file=sys.stderr, flush=True)
            raise ConnectionError(
                f"injected rendezvous failure {attempt + 1}/{n}")


def _scoped(spec: str, scope: str | None) -> str | None:
    """Strip an optional ``"name@"`` replica-scope prefix: the inner spec
    when it applies to ``scope`` (or names no scope), else ``None``."""
    if "@" not in spec:
        return spec
    name, _, inner = spec.partition("@")
    return inner if name == scope else None


def _env_scoped(var: str, scope: str | None) -> str | None:
    spec = os.environ.get(var)
    return _scoped(spec, scope) if spec else None


def serve_nan_at_tick(tick: int, scope: str | None = None) -> int | None:
    """The rid whose decode logits row the scheduler poisons with NaN at
    ``tick``, or ``None``: ``"7"`` fires at tick 7 against rid 0,
    ``"7:3"`` against rid 3. Fires every time the tick matches."""
    spec = _env_scoped("PADDLE_FI_SERVE_NAN_AT_TICK", scope)
    if not spec:
        return None
    part, _, rid = spec.partition(":")
    if int(part) != int(tick):
        return None
    victim = int(rid) if rid else 0
    print(f"[fault-injection] poisoning logits of rid {victim} at serving "
          f"tick {tick}", file=sys.stderr, flush=True)
    return victim


def serve_slow_tick(tick: int, scope: str | None = None) -> float:
    """Seconds the scheduler sleeps inside the decode of ``tick`` (0.0:
    not armed, or not this tick). Grammar as ``nan_at_step``; the length
    is ``PADDLE_FI_SERVE_SLOW_SECS`` (default 0.05)."""
    spec = _env_scoped("PADDLE_FI_SERVE_SLOW_TICK", scope)
    if not spec:
        return 0.0
    tick = int(tick)
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.endswith("+"):
            if tick >= int(part[:-1]):
                break
        elif int(part) == tick:
            break
    else:
        return 0.0
    return float(os.environ.get("PADDLE_FI_SERVE_SLOW_SECS", "0.05") or 0.05)


def serve_pool_pressure() -> int:
    """KV pages the scheduler reserves (and never releases) at
    construction, so small drills reach the evict/recompute paths."""
    n = os.environ.get("PADDLE_FI_SERVE_POOL_PRESSURE")
    if not n:
        return 0
    n = int(n)
    if n > 0:
        print(f"[fault-injection] reserving {n} KV page(s) "
              "(pool-pressure drill)", file=sys.stderr, flush=True)
    return max(0, n)


def _router_spec(var: str, name: str, tick: int):
    """The fields after ``name:tick`` of a ``"name:tick[:secs]"`` spec
    when it is armed for this replica and tick, else ``None``. A
    malformed spec is ignored, loudly: a drill must never crash the
    router it drills."""
    spec = os.environ.get(var)
    if not spec:
        return None
    parts = spec.split(":")
    try:
        want_name, want_tick = parts[0], int(parts[1])
    except (IndexError, ValueError):
        _warn_preempt_once(spec, f"[fault-injection] ignoring malformed "
                           f"{var}={spec!r} (expected 'name:tick[:secs]')")
        return None
    if want_name != name or want_tick != int(tick):
        return None
    return parts[2:]


def router_kill_replica(name: str, tick: int) -> bool:
    """Should replica ``name`` die at ``tick``? Fires once per drill (a
    marker file): the restarted replica keeps its name, and a memoryless
    point would kill every generation at the same tick."""
    if _router_spec("PADDLE_FI_ROUTER_KILL_REPLICA", name, tick) is None:
        return False
    if not _fire_once(f"router_kill_replica-{name}-{tick}"):
        return False
    print(f"[fault-injection] killing replica {name} at tick {tick}",
          file=sys.stderr, flush=True)
    return True


def router_wedge_replica(name: str, tick: int) -> float:
    """Seconds replica ``name``'s tick loop no-ops from ``tick`` on (0.0:
    not armed), default 30; fires once per drill (a marker file)."""
    rest = _router_spec("PADDLE_FI_ROUTER_WEDGE_REPLICA", name, tick)
    if rest is None:
        return 0.0
    if not _fire_once(f"router_wedge_replica-{name}-{tick}"):
        return 0.0
    secs = float(rest[0]) if rest and rest[0] else 30.0
    print(f"[fault-injection] wedging replica {name} for {secs:.1f}s at "
          f"tick {tick}", file=sys.stderr, flush=True)
    return secs


def handoff_drop(rid: int, scope: str | None = None) -> bool:
    """Should the KV handoff transfer of ``rid`` vanish in flight (zero
    pages arrive)? Spec ``"[src@]rid"`` or a comma list of rids."""
    spec = _env_scoped("PADDLE_FI_HANDOFF_DROP", scope)
    if not spec:
        return False
    rid = int(rid)
    for part in spec.split(","):
        part = part.strip()
        if part and int(part) == rid:
            print(f"[fault-injection] dropping KV handoff transfer for "
                  f"rid {rid}", file=sys.stderr, flush=True)
            return True
    return False


def handoff_partial(rid: int, n_pages: int,
                    scope: str | None = None) -> int | None:
    """The page count at which the handoff transfer of ``rid`` truncates,
    or ``None``: spec ``"[src@]rid[:k]"``, default half the pages, and
    never all of them (partial means partial)."""
    spec = _env_scoped("PADDLE_FI_HANDOFF_PARTIAL", scope)
    if not spec:
        return None
    part, _, k = spec.partition(":")
    try:
        if int(part) != int(rid):
            return None
        limit = int(k) if k else max(0, int(n_pages) // 2)
    except ValueError:
        _warn_preempt_once(spec, "[fault-injection] ignoring malformed "
                           f"PADDLE_FI_HANDOFF_PARTIAL={spec!r} (expected "
                           "'[src@]rid[:k]')")
        return None
    limit = min(limit, max(0, int(n_pages) - 1))
    print(f"[fault-injection] truncating KV handoff transfer for rid "
          f"{rid} at {limit}/{n_pages} page(s)", file=sys.stderr,
          flush=True)
    return limit


def handoff_stall(rid: int, scope: str | None = None) -> int:
    """Coordinator pumps the handoff of ``rid`` holds its current stage
    (0: not armed, or another rid): spec ``"[src@]rid[:rounds]"``,
    default 3."""
    spec = _env_scoped("PADDLE_FI_HANDOFF_STALL", scope)
    if not spec:
        return 0
    part, _, rounds = spec.partition(":")
    try:
        if int(part) != int(rid):
            return 0
        n = int(rounds) if rounds else 3
    except ValueError:
        _warn_preempt_once(spec, "[fault-injection] ignoring malformed "
                           f"PADDLE_FI_HANDOFF_STALL={spec!r} (expected "
                           "'[src@]rid[:rounds]')")
        return 0
    print(f"[fault-injection] stalling KV handoff for rid {rid} "
          f"{n} pump(s)", file=sys.stderr, flush=True)
    return max(0, n)
