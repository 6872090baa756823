"""The elastic manager (port of ``paddle_tpu.distributed.fleet.elastic``)
over a ``torch.distributed.TCPStore``.

Each node registers ``nodes/<id>``, claims a roster slot
(``roster_slots`` / ``roster_slot/<n>``) and refreshes
``heartbeat/<id>``; the master compacts the roster into ``roster``,
scans the heartbeats, and publishes the live node set (``live_set``) and
a ``generation`` counter: the generation goes up when the live set
changes after a steady state, and tells every node to exit for a
relaunch with new ranks. A change must survive one confirmation scan, so
a node that drops and comes back within a scan interval (a flap) bumps
nothing. The keys are the JAX package's.
"""
from __future__ import annotations

import threading
import time

__all__ = ["ElasticManager", "ElasticStatus"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """One node's membership over ``store`` (a ``torch.distributed.
    TCPStore``: ``set``, ``get``, ``add``, ``check``, ``delete_key``)."""

    def __init__(self, store, node_id: str, np_range=(1, 64),
                 heartbeat_interval_s: float = 2.0,
                 heartbeat_timeout_s: float = 10.0,
                 is_master: bool = False):
        self.store = store
        self.node_id = node_id
        self.min_np, self.max_np = np_range
        self.interval = heartbeat_interval_s
        self.timeout = heartbeat_timeout_s
        self.is_master = is_master
        self._stop = threading.Event()
        self._thread = None
        self._generation_seen = 0
        # the master's pending live-set change, confirmed on the next scan
        self._pending_live = None

    # -- the store -----------------------------------------------------------

    def _has(self, key) -> bool:
        return self.store.check([key])

    def _get(self, key) -> bytes | None:
        """The key's value, None when it is not set (never blocks)."""
        if not self._has(key):
            return None
        try:
            return self.store.get(key)
        except Exception:
            return None  # deleted between the check and the get

    # -- registration / heartbeat -------------------------------------------

    def register(self):
        self.store.set(f"nodes/{self.node_id}", b"1")
        self._beat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _beat(self):
        from ...utils import fault_injection

        fault_injection.heartbeat_delay()
        self.store.set(f"heartbeat/{self.node_id}", str(time.time()))

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._beat()
                if self.is_master:
                    self._master_scan()
            except Exception:
                pass
            self._stop.wait(self.interval)

    def join_roster(self):
        """Claim a roster slot (once, at start): counter-keyed slots avoid
        a read-modify-write race; the master compacts them."""
        slot = self.store.add("roster_slots", 1)
        self.store.set(f"roster_slot/{slot}", self.node_id)

    # -- master: liveness scan + generation bump ----------------------------

    def _roster_ids(self) -> list:
        roster = self._get("roster") or b""
        return [nid for nid in roster.decode().split(",") if nid]

    def last_heartbeat(self, node_id: str):
        """A node's last heartbeat (epoch seconds), or None."""
        raw = self._get(f"heartbeat/{node_id}")
        try:
            return float(raw) if raw is not None else None
        except ValueError:
            return None

    def _is_live(self, nid: str) -> bool:
        ts = self.last_heartbeat(nid)
        return ts is not None and time.time() - ts < self.timeout

    def _live_nodes(self):
        return [nid for nid in self._roster_ids() if self._is_live(nid)]

    def dead_nodes(self) -> list:
        """Roster members whose heartbeat is stale or missing."""
        return [nid for nid in self._roster_ids() if not self._is_live(nid)]

    def _master_scan(self):
        n = self.store.add("roster_slots", 0)
        members = []
        for slot in range(1, n + 1):
            raw = self._get(f"roster_slot/{slot}")
            if raw is not None:
                members.append(raw.decode())
        self.store.set("roster", ",".join(sorted(set(members))))
        live = self._live_nodes()
        prev = (self._get("live_set") or b"").decode()
        cur = ",".join(sorted(live))
        if cur == prev:
            # steady state; a half-seen flap is forgotten
            self._pending_live = None
            return
        if not prev:
            # first publication: at once, so wait_for_np unblocks
            self.store.set("live_set", cur)
            return
        if self._pending_live != cur:
            self._pending_live = cur  # confirm on the next scan
            return
        self._pending_live = None
        self.store.set("live_set", cur)
        self.store.add("generation", 1)

    # -- worker-side queries -------------------------------------------------

    def generation(self) -> int:
        return self.store.add("generation", 0)

    def should_restart(self) -> bool:
        gen = self.generation()
        if gen != self._generation_seen:
            self._generation_seen = gen
            return True
        return False

    def wait_for_np(self, np_: int, timeout_s: float = 120.0):
        """Block until ``np_`` nodes are live (the job's start gate)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            live = (self._get("live_set") or b"").decode()
            if len([x for x in live.split(",") if x]) >= np_:
                return True
            time.sleep(0.5)
        return False

    def exit(self, completed: bool = True):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        try:
            self.store.delete_key(f"heartbeat/{self.node_id}")
        except Exception:
            pass
