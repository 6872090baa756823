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
"""
from __future__ import annotations

import os
import sys

__all__ = ["armed", "nan_at_step", "preempt_at_step", "serve_nan_at_tick",
           "serve_slow_tick", "serve_pool_pressure", "router_kill_replica",
           "router_wedge_replica", "handoff_drop", "handoff_partial",
           "handoff_stall"]

_ENV = {
    "nan_at_step": "PADDLE_FI_NAN_AT_STEP",
    "preempt_at_step": "PADDLE_FI_PREEMPT_AT_STEP",
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
    if target_step != int(step):
        return False
    if _fi_dir() is None:
        # without the marker dir every relaunched generation would
        # re-preempt at the same boundary, forever
        _warn_preempt_once(target, "[fault-injection] ignoring "
                           "PADDLE_FI_PREEMPT_AT_STEP: PADDLE_FI_DIR is "
                           "required for its fire-once marker")
        return False
    if not _fire_once(f"preempt_at_step-{target}"):
        return False
    print(f"[fault-injection] SIGTERM (preemption notice) at step {step}",
          file=sys.stderr, flush=True)
    return True


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
