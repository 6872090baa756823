"""The launcher (port of ``paddle_tpu.distributed.launch.main``):
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
[--elastic] script.py [args]`` starts N rank processes of ``script.py``
on this host and supervises them.

Each rank gets the JAX pod's variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``,
``PADDLE_NNODES``, ``PADDLE_NODE_RANK``, ``PADDLE_MASTER``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_RESTART_GENERATION``, ``PADDLE_HEARTBEAT_FILE``,
``PADDLE_CONSISTENCY_DIR``, ``PADDLE_OBS_DIR``) and
``torch.distributed``'s (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); a script calls
``paddle_tpu_torch.distributed.init_parallel_env()`` to join the world.
The master port is a free port held by the launcher until the ranks
start, and a new one every generation (the last one may sit in
TIME_WAIT). Multi-node jobs rendezvous over a ``torch.distributed.
TCPStore`` at ``--master``, with retries and jittered backoff, and agree
there on the endpoints and on each generation's master.

The watcher (:mod:`.watcher`) classifies each exit. When a rank dies the
launcher terminates the rest of the pod (SIGTERM, then SIGKILL after
``--grace_secs``: ranks blocked in a collective on a dead peer would
otherwise wait out the process group's timeout) and then:

- ``crash``, ``hang``, ``divergence`` and ``desync``: with ``--elastic``
  and restart budget left, a relaunch of the whole pod after a bounded
  exponential backoff with jitter, ``PADDLE_RESTART_GENERATION`` + 1
  (a desync's relaunch is the full restart from the newest common
  checkpoint it needs); otherwise the launcher exits 1;
- ``preemption`` (every failed rank exited 118): with ``--elastic`` a
  relaunch at once, costing neither backoff nor budget; without it the
  launcher exits 118 for an outer supervisor.

SIGTERM and SIGINT to the launcher are forwarded to the pod. Lifecycle
events (``relaunch``, ``rendezvous_retry``, ``job_failed``, ...) go to
``$PADDLE_OBS_DIR/metrics-launcher-node<k>.jsonl`` in the sink's format.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta

from .watcher import PREEMPTED_EXIT_CODE, ExitKind, Watcher

__all__ = ["launch", "main", "Pod", "CollectiveController"]


_OBS_WORKER = "launcher-node0"


def _obs_event(name: str, **fields) -> None:
    """Append a launcher lifecycle event to the run's telemetry stream
    (``$PADDLE_OBS_DIR``; a no-op without it)."""
    d = os.environ.get("PADDLE_OBS_DIR", "").strip()
    if not d:
        return
    rec = {"ts": round(time.time(), 6), "worker": _OBS_WORKER,
           "kind": "event", "name": name}
    rec.update(fields)
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"metrics-{_OBS_WORKER}.jsonl"), "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
    except OSError:
        pass  # telemetry must never take the job down


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--nnodes", type=int, default=1, help="number of hosts")
    p.add_argument("--node_rank", type=int, default=0, help="this host's rank")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="rank processes on this host (default 1)")
    p.add_argument("--master", default=None,
                   help="master endpoint host:port (required for nnodes>1)")
    p.add_argument("--devices", default=None,
                   help="comma-separated CUDA device ids the pod may use "
                        "(CUDA_VISIBLE_DEVICES of every rank)")
    p.add_argument("--log_dir", default=None, help="per-rank log directory")
    p.add_argument("--elastic", action="store_true",
                   help="relaunch the pod when a rank fails")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--hang_timeout", type=float, default=0.0,
                   help="seconds of heartbeat-file staleness before a "
                        "running rank is hung (0 disables)")
    p.add_argument("--restart_backoff", type=float, default=0.5,
                   help="base seconds of the exponential relaunch backoff")
    p.add_argument("--grace_secs", type=float, default=10.0,
                   help="seconds between SIGTERM to the pod and SIGKILL")
    p.add_argument("--straggler_ratio", type=float, default=2.0,
                   help="flag a rank whose rolling step time exceeds this "
                        "multiple of the others' median (0 disables)")
    p.add_argument("--straggler_windows", type=int, default=3,
                   help="heartbeat windows in a row above the ratio "
                        "before the straggler event")
    p.add_argument("--obs_dir", default=None,
                   help="telemetry directory (PADDLE_OBS_DIR of the ranks "
                        "and of the launcher's own events)")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _probe_free_ports(n: int, host: str = "127.0.0.1",
                      attempts: int = 5) -> list:
    """``n`` distinct free ports (each bound to port 0, all held until
    the last is bound), with retry and backoff."""
    last_err = None
    for attempt in range(attempts):
        socks = []
        try:
            for _ in range(n):
                s = socket.socket()
                s.bind((host, 0))
                socks.append(s)
            return [s.getsockname()[1] for s in socks]
        except OSError as e:
            last_err = e
        finally:
            for s in socks:
                s.close()
        time.sleep(0.1 * (2 ** attempt) + random.uniform(0, 0.05))
    raise RuntimeError(f"could not probe {n} free ports: {last_err}")


def _hold_port(avoid: set, host: str = "") -> socket.socket:
    """A bound socket on a free port below the ephemeral range, none of
    ``avoid``, derived from the launcher's pid (two launches on a host
    start apart); the caller holds it until the ranks start."""
    base = 20000 + (os.getpid() % 12000)
    for i in range(512):
        cand = 20000 + (base - 20000 + i) % 12000
        if cand in avoid:
            continue
        s = socket.socket()
        try:
            s.bind((host, cand))
        except OSError:
            s.close()
            continue
        return s
    raise RuntimeError(f"no free master port from {base}")


class Pod:
    """The rank processes on this host."""

    def __init__(self, args):
        self.args = args
        self.procs: list = []
        self.logs: list = []
        self.restarts = 0
        self.restart_generation = 0
        self.heartbeat_paths: list = []

    def _hb_dir(self) -> str:
        d = self.args.log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"paddle_launch_{os.getpid()}")
        os.makedirs(d, exist_ok=True)
        return d

    def _env_for(self, local_rank: int, nproc: int, master: str,
                 endpoint_list: list) -> dict:
        env = dict(os.environ)
        global_rank = self.args.node_rank * nproc + local_rank
        world = self.args.nnodes * nproc
        hb = os.path.join(self._hb_dir(), f"hb-rank{global_rank}")
        if len(self.heartbeat_paths) <= local_rank:
            self.heartbeat_paths.append(hb)
        else:
            self.heartbeat_paths[local_rank] = hb
        addr, port = master.rsplit(":", 1)
        env.update({
            "PADDLE_TRAINER_ID": str(global_rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_LOCAL_SIZE": str(nproc),
            "PADDLE_NNODES": str(self.args.nnodes),
            "PADDLE_NODE_RANK": str(self.args.node_rank),
            "PADDLE_MASTER": master,
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoint_list),
            "PADDLE_CURRENT_ENDPOINT": endpoint_list[global_rank],
            # 0 on the first attempt, +1 a relaunch: scripts resume from
            # the newest checkpoint when it is above 0
            "PADDLE_RESTART_GENERATION": str(self.restart_generation),
            "PADDLE_HEARTBEAT_FILE": hb,
            # the trainer's consistency check exchanges digests here
            "PADDLE_CONSISTENCY_DIR": os.path.join(self._hb_dir(),
                                                   "consistency"),
            "MASTER_ADDR": addr,
            "MASTER_PORT": port,
            "RANK": str(global_rank),
            "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(nproc),
        })
        if self.args.devices:
            env["CUDA_VISIBLE_DEVICES"] = self.args.devices
        if getattr(self.args, "obs_dir", None):
            env["PADDLE_OBS_DIR"] = self.args.obs_dir
        return env

    def start(self, master: str, endpoints: list | None = None):
        """Start the ranks against ``master`` (``host:port`` of
        ``torch.distributed``'s store); ``endpoints`` is the agreed
        rank -> endpoint list (probed here on one node)."""
        nproc = self.args.nproc_per_node or 1
        world = self.args.nnodes * nproc
        if endpoints is None:
            endpoints = [f"127.0.0.1:{p}" for p in _probe_free_ports(world)]
        self.procs = []
        self._close_logs()
        for lr in range(nproc):
            out = None
            if self.args.log_dir:
                os.makedirs(self.args.log_dir, exist_ok=True)
                rank = self.args.node_rank * nproc + lr
                # append: a relaunch keeps the failed attempt's log
                out = open(os.path.join(self.args.log_dir,
                                        f"rank{rank}.log"), "a")
                self.logs.append(out)
            cmd = [sys.executable, self.args.training_script] + list(
                self.args.training_script_args)
            env = self._env_for(lr, nproc, master, endpoints)
            # drop the last generation's heartbeat file: staleness counts
            # from this attempt's own beats (else a relaunch is "hung")
            try:
                os.remove(self.heartbeat_paths[lr])
            except OSError:
                pass
            self.procs.append(subprocess.Popen(
                cmd, env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None))

    def _close_logs(self):
        for f in self.logs:
            try:
                f.close()
            except OSError:
                pass
        self.logs = []

    def forward_signal(self, sig) -> None:
        """Relay a signal to every live rank."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def terminate(self, grace_s: float = 10.0):
        """SIGTERM every live rank, SIGKILL those alive after
        ``grace_s``, and reap them all."""
        self.forward_signal(signal.SIGTERM)
        deadline = time.time() + grace_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        self._close_logs()


def _retry_rendezvous(make, attempts: int = 5, base_delay_s: float = 0.5,
                      max_delay_s: float = 10.0, what: str = "rendezvous"):
    """``make()`` with bounded exponential backoff and jitter over the
    transient errors (a refused connect, a timeout: ``RuntimeError`` is
    how TCPStore reports them); other errors propagate at once."""
    from ...utils import fault_injection

    last = None
    for attempt in range(attempts):
        try:
            fault_injection.rendezvous()
            return make()
        except (ConnectionError, TimeoutError, RuntimeError, OSError) as e:
            last = e
            _obs_event("rendezvous_retry", attempt=attempt + 1,
                       attempts=attempts, what=what, error=str(e)[:200])
            if attempt == attempts - 1:
                break
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            delay *= 1.0 + random.uniform(0.0, 0.25)
            print(f"[launch] {what} attempt {attempt + 1}/{attempts} failed "
                  f"({e}); retrying in {delay:.2f}s", file=sys.stderr)
            time.sleep(delay)
    raise RuntimeError(
        f"{what} failed after {attempts} attempts: {last}") from last


def _store_barrier(store, name: str, n: int, timeout_s: float = 300.0):
    """Every one of ``n`` participants adds itself; wait for all."""
    key = f"__barrier/{name}"
    store.add(key, 1)
    deadline = time.time() + timeout_s
    while store.add(key, 0) < n:
        if time.time() > deadline:
            raise TimeoutError(f"store barrier {name!r}: "
                               f"{store.add(key, 0)} of {n} arrived")
        time.sleep(0.05)


class CollectiveController:
    """Runs the pod under the watcher and the relaunch rules."""

    def __init__(self, args):
        self.args = args
        self.pod = Pod(args)
        self._store = None
        self._port_guard = None   # the master port, held until the start
        self._used_ports: set = set()

    def _rendezvous(self) -> None:
        """Multi-node: node 0 serves a TCPStore at ``--master``, every
        node registers and waits for the others."""
        if self.args.nnodes <= 1:
            return
        from torch.distributed import TCPStore

        host, port = self.args.master.rsplit(":", 1)
        is_master = self.args.node_rank == 0

        def connect_and_register():
            store = TCPStore(host, int(port), is_master=is_master,
                             timeout=timedelta(seconds=300),
                             wait_for_workers=False)
            store.add("__nodes_joined", 1)
            return store

        self._store = _retry_rendezvous(connect_and_register,
                                        what="TCPStore rendezvous")
        _store_barrier(self._store, "launch", self.args.nnodes)

    def _exchange_endpoints(self, nproc: int) -> list | None:
        """Multi-node: one rank -> endpoint list, agreed through the
        store."""
        if self._store is None:
            return None
        local = ",".join(f"127.0.0.1:{p}" for p in _probe_free_ports(nproc))
        self._store.set(f"__endpoints/{self.args.node_rank}", local)
        _store_barrier(self._store, "endpoints", self.args.nnodes)
        eps = []
        for nr in range(self.args.nnodes):
            eps.extend(self._store.get(f"__endpoints/{nr}").decode()
                       .split(","))
        return eps

    def _master_for_generation(self) -> str:
        """This generation's ``torch.distributed`` master: a new port
        each time, held bound until the pod starts; node 0 publishes it
        to the other nodes."""
        gen = self.pod.restart_generation
        host = "127.0.0.1"
        if self.args.nnodes > 1:
            host = self.args.master.rsplit(":", 1)[0]
            if self.args.node_rank != 0:
                return self._store.get(f"__dist_master/{gen}").decode()
        elif self.args.master:
            return self.args.master
        self._port_guard = _hold_port(self._used_ports,
                                      "" if self.args.nnodes > 1 else host)
        port = self._port_guard.getsockname()[1]
        self._used_ports.add(port)
        master = f"{host}:{port}"
        if self._store is not None:
            self._store.set(f"__dist_master/{gen}", master)
        return master

    def _backoff(self, restarts: int) -> float:
        base = max(0.05, self.args.restart_backoff)
        delay = min(30.0, base * (2 ** max(0, restarts - 1)))
        return delay * (1.0 + random.uniform(0.0, 0.25))

    def run(self) -> int:
        self._rendezvous()
        endpoints = self._exchange_endpoints(self.args.nproc_per_node or 1)
        watcher = Watcher(self.pod, hang_timeout_s=self.args.hang_timeout,
                          heartbeat_paths=self.pod.heartbeat_paths,
                          straggler_ratio=self.args.straggler_ratio,
                          straggler_windows=self.args.straggler_windows,
                          obs_event=_obs_event,
                          # sibling ranks dying ms apart classify by
                          # severity, not by which exit the scan saw first
                          settle_s=0.5)
        restarts = 0
        while True:
            master = self._master_for_generation()
            if self._port_guard is not None:
                # released at the last moment: rank 0 binds it next
                self._port_guard.close()
                self._port_guard = None
            self.pod.start(master, endpoints)
            watcher.heartbeat_paths = self.pod.heartbeat_paths
            watcher.reset_straggler_state()
            while True:
                event = watcher.scan()
                if event is None:
                    time.sleep(0.2)
                    continue
                if event.kind == ExitKind.CLEAN:
                    _obs_event("job_clean_exit", restarts=restarts)
                    return 0
                if event.kind == ExitKind.PREEMPTION:
                    if self.args.elastic:
                        # the ranks wrote their just-in-time checkpoint:
                        # relaunch now, at no backoff and no budget
                        self.pod.restart_generation += 1
                        _obs_event("relaunch", kind=event.kind,
                                   detail=event.detail[:300],
                                   restart=restarts,
                                   max_restarts=self.args.max_restarts,
                                   generation=self.pod.restart_generation,
                                   backoff_s=0.0)
                        print(f"[launch] preemption: {event.detail}; "
                              f"relaunching immediately (generation "
                              f"{self.pod.restart_generation}, no restart "
                              "budget consumed)", file=sys.stderr,
                              flush=True)
                        self.pod.terminate(grace_s=self.args.grace_secs)
                        break
                    _obs_event("job_preempted", detail=event.detail[:300],
                               restarts=restarts)
                    print(f"[launch] preemption: {event.detail} "
                          "(--elastic not set: exiting with the "
                          "preemption status for an outer supervisor)",
                          file=sys.stderr, flush=True)
                    self.pod.terminate(grace_s=self.args.grace_secs)
                    return PREEMPTED_EXIT_CODE
                # crash, hang, divergence or desync: every rank is torn
                # down and the generation resumes from the newest common
                # checkpoint (a desynced rank's memory is never reused)
                if self.args.elastic and restarts < self.args.max_restarts:
                    restarts += 1
                    self.pod.restarts = restarts
                    self.pod.restart_generation += 1
                    delay = self._backoff(restarts)
                    _obs_event("relaunch", kind=event.kind,
                               detail=event.detail[:300], restart=restarts,
                               max_restarts=self.args.max_restarts,
                               generation=self.pod.restart_generation,
                               backoff_s=round(delay, 3))
                    print(f"[launch] {event.kind}: {event.detail}; relaunch "
                          f"{restarts}/{self.args.max_restarts} "
                          f"(generation {self.pod.restart_generation}) "
                          f"after {delay:.2f}s backoff", file=sys.stderr,
                          flush=True)
                    self.pod.terminate(grace_s=self.args.grace_secs)
                    time.sleep(delay)
                    break
                exhausted = ("; restart budget exhausted"
                             if self.args.elastic else "")
                _obs_event("job_failed", kind=event.kind,
                           detail=event.detail[:300], restarts=restarts,
                           budget_exhausted=bool(self.args.elastic))
                print(f"[launch] {event.kind}: {event.detail}{exhausted}",
                      file=sys.stderr, flush=True)
                self.pod.terminate(grace_s=self.args.grace_secs)
                return 1


def launch(argv=None) -> int:
    """Parse the arguments and run the pod; returns the exit code."""
    args = _parse_args(argv)
    if args.nnodes > 1 and not args.master:
        print("--master host:port is required for multi-node jobs",
              file=sys.stderr)
        return 2
    if args.obs_dir:
        os.environ["PADDLE_OBS_DIR"] = args.obs_dir
    global _OBS_WORKER
    _OBS_WORKER = f"launcher-node{args.node_rank}"
    controller = CollectiveController(args)

    # ranks die with the launcher, never linger as orphans
    def _relay(signum, frame):
        controller.pod.forward_signal(signum)
        raise KeyboardInterrupt

    old_term = signal.signal(signal.SIGTERM, _relay)
    old_int = signal.signal(signal.SIGINT, _relay)
    try:
        return controller.run()
    except KeyboardInterrupt:
        controller.pod.terminate(grace_s=args.grace_secs)
        # a SIGTERM that every rank answered with a graceful preemption
        # exit is a preemption to an outer supervisor too
        rcs = [p.poll() for p in controller.pod.procs]
        nonzero = [rc for rc in rcs if rc not in (0, None)]
        if nonzero and all(rc == PREEMPTED_EXIT_CODE for rc in nonzero):
            return PREEMPTED_EXIT_CODE
        return 130
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def main():
    sys.exit(launch())
