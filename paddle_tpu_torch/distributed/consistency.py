"""The cross-rank consistency check: desync detection for SPMD training
(port of ``paddle_tpu.distributed.consistency``).

Every K steps (``TrainerConfig.consistency_check_every``) the trainer
builds a digest (the global step, the low 64 bits of a hash of the full
params, the loss bits, the loss scale, the data cursor's hash), and every
rank all-gathers it through a :class:`DigestExchange`. On a mismatch
:class:`DesyncError` is raised with a per-field, per-rank diff and the
suspect ranks; the process should exit :data:`DESYNC_EXIT_CODE` (119),
which the launcher's watcher classifies as ``desync``: a full restart
from the newest common checkpoint.

The exchange is a shared directory, like the launcher's heartbeats:
each rank writes ``$PADDLE_CONSISTENCY_DIR/gen<G>/step-<N>/rank-<R>.json``
atomically and polls for its peers'. The layout and the digests are the
JAX package's (:func:`tree_digest64` hashes the same bytes in the same
leaf order), so a rank of either package reads the other's. The wait is
a blocking collective and runs inside
``collective_span("consistency_all_gather")``: a timeout dumps the
flight ring before :class:`CollectiveStallError` names the ranks that
never arrived.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import time
from typing import Dict, Optional

import numpy as np

__all__ = [
    "DESYNC_EXIT_CODE",
    "DIGEST_FIELDS",
    "DesyncError",
    "CollectiveStallError",
    "DigestExchange",
    "ConsistencyChecker",
    "compare_digests",
    "format_diff",
    "default_exchange_dir",
    "tree_digest64",
    "json_digest64",
    "float_bits",
    "rank_world",
]

DESYNC_EXIT_CODE = 119

# the digest fields, in report order; every rank must agree on each
DIGEST_FIELDS = ("step", "params_hash", "loss_bits", "loss_scale",
                 "data_cursor")


class DesyncError(RuntimeError):
    """Ranks disagree on replicated state: ``diff`` is ``{field: {rank:
    value}}``, ``suspects`` the minority ranks (every disagreeing rank
    when no strict majority exists). Exit :data:`DESYNC_EXIT_CODE`."""

    exit_code = DESYNC_EXIT_CODE

    def __init__(self, msg, step=None, diff=None, suspects=None):
        super().__init__(msg)
        self.step = step
        self.diff = diff or {}
        self.suspects = list(suspects or [])


class CollectiveStallError(RuntimeError):
    """A digest exchange timed out: some ranks never entered it. The
    flight ring was dumped before this was raised."""

    def __init__(self, msg, step=None, missing_ranks=None):
        super().__init__(msg)
        self.step = step
        self.missing_ranks = list(missing_ranks or [])


def rank_world() -> tuple:
    """``(rank, world_size)`` from the launcher's environment; ``(0, 1)``
    standalone."""
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1))


def _leaves(tree):
    """The leaves in ``jax.tree_util.tree_leaves`` order: dict keys
    sorted, lists and tuples in order, None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host array with the bytes JAX would hash (a bfloat16
    tensor as its raw 16-bit words)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def tree_digest64(tree) -> int:
    """Low 64 bits of a blake2b over every leaf's shape and bytes, in
    tree order: ranks holding bit-identical state give equal digests,
    and the same values give the JAX package's digest."""
    h = hashlib.blake2b(digest_size=8)
    for leaf in _leaves(tree):
        arr = _host(leaf)
        h.update(arr.shape.__repr__().encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return int.from_bytes(h.digest(), "little")


def json_digest64(obj) -> int:
    """Low 64 bits of a blake2b over a canonical JSON encoding (data
    cursors, config blobs)."""
    payload = json.dumps(obj, sort_keys=True, default=str).encode()
    return int.from_bytes(
        hashlib.blake2b(payload, digest_size=8).digest(), "little")


def float_bits(x) -> int:
    """The float64 bit pattern of a scalar (a tensor's too): the loss is
    compared bitwise, so two NaN losses are equal and 1e-300 apart are
    not."""
    return struct.unpack("<Q", struct.pack("<d", float(x)))[0]


def compare_digests(gathered: Dict[int, dict]) -> tuple:
    """``(diff, suspects)`` of the per-rank digests: ``diff`` maps each
    field the ranks disagree on to ``{rank: value}`` (empty when they
    agree); ``suspects`` are the ranks holding a minority value where a
    strict majority exists, else every disagreeing rank."""
    diff: Dict[str, Dict[int, object]] = {}
    minority: set = set()
    for field in DIGEST_FIELDS:
        values = {r: d.get(field) for r, d in gathered.items()}
        if len(set(values.values())) <= 1:
            continue
        diff[field] = values
        counts: Dict[object, int] = {}
        for v in values.values():
            counts[v] = counts.get(v, 0) + 1
        top = max(counts.values())
        if top * 2 > len(values):
            majority = next(v for v, c in counts.items() if c == top)
            minority.update(r for r, v in values.items() if v != majority)
    if diff and not minority:
        minority = {r for vals in diff.values() for r in vals}
    return diff, sorted(minority)


def format_diff(step: int, diff: dict, suspects: list) -> str:
    lines = [f"cross-rank desync at consistency check step {step}: "
             f"ranks disagree on {sorted(diff)}; suspect rank(s): "
             f"{suspects}"]
    for field in sorted(diff):
        per_rank = ", ".join(
            f"rank {r}={diff[field][r]!r}" for r in sorted(diff[field]))
        lines.append(f"  {field}: {per_rank}")
    return "\n".join(lines)


class DigestExchange:
    """A digest all-gather over a shared directory:
    ``<dir>/gen<G>/step-<N>/rank-<R>.json``. The restart generation keys
    the namespace, so a relaunch never reads the last generation's
    digests; writes are atomic (tmp + rename); each rank removes only
    its own older files after a gather."""

    def __init__(self, directory: str, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 generation: Optional[int] = None):
        env_rank, env_world = rank_world()
        self.rank = env_rank if rank is None else int(rank)
        self.world = env_world if world is None else int(world)
        if generation is None:
            generation = int(
                os.environ.get("PADDLE_RESTART_GENERATION", "0") or 0)
        self.dir = os.path.join(directory, f"gen{generation}")
        self._written_steps: list = []

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step}")

    def _rank_file(self, step: int, rank: int) -> str:
        return os.path.join(self._step_dir(step), f"rank-{rank}.json")

    def publish(self, step: int, digest: dict) -> None:
        os.makedirs(self._step_dir(step), exist_ok=True)
        path = self._rank_file(step, self.rank)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(digest, sort_keys=True))
        os.replace(tmp, path)
        self._written_steps.append(step)

    def gather(self, step: int, timeout_s: float,
               poll_s: float = 0.02) -> Dict[int, dict]:
        """Every rank's digest for ``step``, ``{rank: digest}``; raises
        :class:`CollectiveStallError` (after dumping the flight ring)
        when the peers do not arrive within ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        out: Dict[int, dict] = {}
        while True:
            for r in range(self.world):
                if r in out:
                    continue
                try:
                    with open(self._rank_file(step, r)) as f:
                        out[r] = json.loads(f.read())
                except (OSError, ValueError):
                    pass  # absent or mid-rename: poll again
            if len(out) == self.world:
                return out
            if time.monotonic() >= deadline:
                missing = sorted(set(range(self.world)) - set(out))
                from .collective_runtime import flight_recorder

                flight_recorder().dump(
                    reason=f"consistency_all_gather step {step} timed "
                           f"out after {timeout_s:.1f}s; ranks never "
                           f"entered: {missing}")
                raise CollectiveStallError(
                    f"consistency check at step {step}: rank(s) "
                    f"{missing} never published a digest within "
                    f"{timeout_s:.1f}s — a peer is stalled or dead "
                    "(flight ring dumped; merge with "
                    "tools/obs_report.py --flight)",
                    step=step, missing_ranks=missing)
            time.sleep(poll_s)

    def cleanup_before(self, step: int) -> None:
        """Drop this rank's own digest files of steps before ``step``;
        the last rank out removes the empty step directory."""
        keep, drop = [], []
        for s in self._written_steps:
            (drop if s < step else keep).append(s)
        for s in drop:
            try:
                os.remove(self._rank_file(s, self.rank))
            except OSError:
                pass
            try:
                os.rmdir(self._step_dir(s))
            except OSError:
                pass  # a peer's file is still there
        self._written_steps = keep


def default_exchange_dir() -> Optional[str]:
    """``PADDLE_CONSISTENCY_DIR`` (the launcher sets it beside the
    heartbeat files), else ``consistency/`` under ``PADDLE_OBS_DIR``."""
    d = os.environ.get("PADDLE_CONSISTENCY_DIR", "").strip()
    if d:
        return d
    obs = os.environ.get("PADDLE_OBS_DIR", "").strip()
    return os.path.join(obs, "consistency") if obs else None


class ConsistencyChecker:
    """The periodic check the trainer drives: :meth:`maybe_check` is free
    off the K-step grid; on it the digest is built, all-gathered and
    diffed, and a mismatch raises :class:`DesyncError`."""

    def __init__(self, every: int, exchange: DigestExchange,
                 timeout_s: Optional[float] = None):
        if every < 1:
            raise ValueError(f"consistency check interval must be >= 1, "
                             f"got {every}")
        self.every = int(every)
        self.exchange = exchange
        if timeout_s is None:
            timeout_s = float(
                os.environ.get("PADDLE_CONSISTENCY_TIMEOUT_S", "300")
                or 300)
        self.timeout_s = timeout_s
        self.checks = 0

    def maybe_check(self, step: int, digest_fn) -> Optional[dict]:
        if step % self.every:
            return None
        return self.check(step, digest_fn())

    def check(self, step: int, digest: dict) -> dict:
        """All-gather ``digest`` for ``step`` and diff it; the gathered
        ``{rank: digest}`` when the ranks agree."""
        from .. import observability as obs
        from .collective_runtime import collective_span, flight_recorder

        self.exchange.publish(step, digest)
        with collective_span("consistency_all_gather"):
            gathered = self.exchange.gather(step, timeout_s=self.timeout_s)
        self.exchange.cleanup_before(step)
        self.checks += 1
        obs.counter("consistency_checks_total").inc()
        diff, suspects = compare_digests(gathered)
        if not diff:
            return gathered
        msg = format_diff(step, diff, suspects)
        obs.counter("desync_detected_total").inc()
        if obs.enabled():
            obs.emit({"kind": "event", "name": "desync", "step": int(step),
                      "fields": sorted(diff), "suspects": suspects})
        flight_recorder().dump(reason=f"desync detected at step {step}")
        raise DesyncError(msg, step=step, diff=diff, suspects=suspects)
