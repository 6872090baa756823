"""The port's launcher, watcher and elastic manager against the JAX
package's, on the CPU.

- the port's and the JAX package's ``Watcher`` classify the same fake
  pods the same way (clean, crash, signal, 117, 118, 119, hang by
  heartbeat), with equal exit codes;
- the port's ``ElasticManager`` over a ``torch.distributed.TCPStore``
  walks the JAX manager's scripted membership and generation sequence
  (over the JAX package's native store);
- the launcher's environment holds every key of the JAX pod's;
- ``ops.kernels._build.load_library`` builds once across processes;
- drills through ``python -m paddle_tpu_torch.distributed.launch`` over
  2 CPU ranks, as ``tests/test_launch.py`` runs the JAX launcher: env
  wiring (``init_parallel_env`` over gloo), a propagated failure, an
  elastic restart, SIGTERM forwarding, a hang relaunch, rendezvous
  retries across two launcher nodes, a SIGKILL mid-training resumed bit
  for bit from the newest multi-rank checkpoint, and a preemption with
  zero lost steps.
"""
import argparse
import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in list(env):
        if k.startswith("PADDLE_"):
            del env[k]
    env.update(extra)
    return env


def _launch(script_body, tmp_path, args=(), timeout=120, **env):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(script_body))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           *args, str(script)]
    return subprocess.run(cmd, env=_env(**env), capture_output=True,
                          text=True, timeout=timeout, cwd=str(tmp_path))


# -- the watcher, held to the JAX package's ------------------------------------

class _FakeProc:
    def __init__(self, rc):
        self.rc = rc

    def poll(self):
        return self.rc


class _FakePod:
    def __init__(self, rcs):
        self.procs = [_FakeProc(rc) for rc in rcs]


PODS = [[0, 0], [0, 3], [None, -9], [118, 118], [118, 1], [None, 118],
        [117, 118], [119, 1], [None, None], [119, -15, 117]]


def test_exit_codes_equal_the_jax_packages():
    from paddle_tpu.distributed import consistency as jc
    from paddle_tpu.distributed.launch import watcher as jw
    from paddle_tpu.parallel import hybrid as jh
    from paddle_tpu_torch.distributed import consistency as tc
    from paddle_tpu_torch.distributed.launch import watcher as tw
    from paddle_tpu_torch.parallel import hybrid as th
    from paddle_tpu_torch.utils import preemption as tp

    for name in ("DIVERGENCE_EXIT_CODE", "PREEMPTED_EXIT_CODE",
                 "DESYNC_EXIT_CODE"):
        assert getattr(tw, name) == getattr(jw, name), name
    assert (tw.DIVERGENCE_EXIT_CODE, tw.PREEMPTED_EXIT_CODE,
            tw.DESYNC_EXIT_CODE) == (th.DIVERGENCE_EXIT_CODE,
                                     tp.PREEMPTED_EXIT_CODE,
                                     tc.DESYNC_EXIT_CODE)
    assert th.DESYNC_EXIT_CODE == jh.DESYNC_EXIT_CODE == jc.DESYNC_EXIT_CODE


@pytest.mark.parametrize("rcs", PODS, ids=[str(p) for p in PODS])
def test_watcher_classifies_fake_pods_as_the_jax_watcher(rcs):
    from paddle_tpu.distributed.launch.watcher import Watcher as JW
    from paddle_tpu_torch.distributed.launch.watcher import Watcher as TW

    got, want = TW(_FakePod(rcs)).scan(), JW(_FakePod(rcs)).scan()
    if want is None:
        assert got is None
    else:
        assert (got.kind, got.ranks, got.detail) == (
            want.kind, want.ranks, want.detail)


def test_watcher_hang_by_heartbeat_and_settle_as_the_jax_watcher(tmp_path):
    """A stale heartbeat is a hang naming the last step; a fresh one is
    healthy; a rank without a file is exempt; the settle window holds a
    failure while a peer is alive, then classifies by severity."""
    from paddle_tpu.distributed.launch import watcher as jw
    from paddle_tpu_torch.distributed.launch import watcher as tw

    hb = [str(tmp_path / f"hb{i}") for i in range(3)]
    tw.touch_heartbeat(hb[0], step=41, step_ms=12.5)
    old = time.time() - 100
    os.utime(hb[0], (old, old))
    tw.touch_heartbeat(hb[1])
    assert tw.read_heartbeat(hb[0])["step"] == 41
    assert tw.read_heartbeat(hb[1]) is None
    assert jw.read_heartbeat(hb[0]) == tw.read_heartbeat(hb[0])
    res = []
    for mod in (tw, jw):
        ev = mod.Watcher(_FakePod([None, None, None]), hang_timeout_s=5.0,
                         heartbeat_paths=hb).scan()
        res.append((ev.kind, ev.ranks, ev.detail))
    assert res[0] == res[1]
    assert res[0][0] == "hang" and "last step 41" in res[0][2]
    for mod in (tw, jw):
        pod = _FakePod([119, None])
        w = mod.Watcher(pod, settle_s=0.3)
        assert w.scan() is None            # the peer is still alive
        pod.procs[1].rc = -9
        time.sleep(0.35)
        assert w.scan().kind == "desync"


def _beat(path, step, ms):
    with open(path, "w") as f:
        f.write(json.dumps({"step": step, "ts": time.time(), "step_ms": ms}))


def test_watcher_flags_stragglers_as_the_jax_watcher(tmp_path):
    """Three ranks, rank 2 at 3x the others' step time: both watchers
    emit the same ``straggler`` event after the same window, once."""
    from paddle_tpu.distributed.launch.watcher import Watcher as JW
    from paddle_tpu_torch.distributed.launch.watcher import Watcher as TW

    hb = [str(tmp_path / f"hb{i}") for i in range(3)]
    events = {}
    for name, cls in (("port", TW), ("jax", JW)):
        got = []
        w = cls(_FakePod([None] * 3), heartbeat_paths=hb,
                straggler_ratio=2.0, straggler_windows=2,
                obs_event=lambda n, **f: got.append((n, f)))
        for step in range(1, 5):
            for i, ms in enumerate((10.0, 11.0, 33.0)):
                _beat(hb[i], step, ms)
            assert w.scan() is None
        events[name] = [(n, {k: v for k, v in f.items()}) for n, f in got]
    assert events["port"] == events["jax"]
    assert [f["rank"] for _, f in events["port"]] == [2]


def test_fault_points_fire_as_the_jax_packages(tmp_path, monkeypatch):
    """The launcher's fault points answer as the JAX package's, rank by
    rank (``PADDLE_FI_KILL_RANK`` picks the rank; the preemption point
    too) and once per drill, each package with its own marker dir."""
    from paddle_tpu.utils import fault_injection as jfi
    from paddle_tpu_torch.utils import fault_injection as tfi

    monkeypatch.setenv("PADDLE_FI_PREEMPT_AT_STEP", "3")
    monkeypatch.setenv("PADDLE_FI_DESYNC_AT_STEP", "3")
    monkeypatch.setenv("PADDLE_FI_STALL_AT_STEP", "3")
    monkeypatch.setenv("PADDLE_FI_STALL_SECS", "7")
    monkeypatch.setenv("PADDLE_FI_KILL_AT_STEP", "3")
    monkeypatch.setenv("PADDLE_FI_KILL_RANK", "1")
    monkeypatch.setenv("PADDLE_FI_FAIL_RENDEZVOUS_N", "2")
    answers = {}
    for name, mod in (("port", tfi), ("jax", jfi)):
        monkeypatch.setenv("PADDLE_FI_DIR", str(tmp_path / name))
        got = []
        for rank in ("0", "1", "1"):
            monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
            got.append((mod.preempt_at_step(3), mod.preempt_at_step(4),
                        mod.desync_at_step(3), mod.stall_at_step(3)))
            if rank == "0":
                mod.at_step(3)             # not the targeted rank
        for _ in range(3):
            try:
                mod.rendezvous()
                got.append("ok")
            except ConnectionError as e:
                got.append(str(e))
        answers[name] = got
    assert answers["port"] == answers["jax"]
    assert answers["port"][:3] == [(False, False, False, 0.0),
                                   (True, False, True, 7.0),
                                   (False, False, False, 0.0)]


# -- the elastic manager -------------------------------------------------------

def _elastic_script(mgr, store_set, store_delete):
    """The JAX test's scripted scans: two members, a flap (drop and back
    within a scan), then a real death; the observable state after each
    scan."""
    seen = []

    def look():
        seen.append((mgr._get_live(), mgr.generation(), mgr.dead_nodes()))

    for nid in ("n0", "n1"):
        slot = mgr.store.add("roster_slots", 1)
        store_set(f"roster_slot/{slot}", nid)
        store_set(f"heartbeat/{nid}", str(time.time()))
    mgr._master_scan()
    look()
    store_delete("heartbeat/n1")
    mgr._master_scan()
    look()
    store_set("heartbeat/n1", str(time.time()))
    mgr._master_scan()
    mgr._master_scan()
    look()
    store_delete("heartbeat/n1")
    mgr._master_scan()
    look()
    mgr._master_scan()
    look()
    return seen


def test_elastic_manager_walks_the_jax_managers_sequence():
    from datetime import timedelta

    from torch.distributed import TCPStore

    from paddle_tpu import core
    from paddle_tpu.distributed.fleet.elastic import ElasticManager as JM
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager as TM

    kw = dict(node_id="n0", is_master=True, heartbeat_interval_s=0.2,
              heartbeat_timeout_s=1.0)
    jstore = core.TCPStore("127.0.0.1", 0, is_master=True)
    tstore = TCPStore("127.0.0.1", 0, is_master=True,
                      timeout=timedelta(seconds=10), wait_for_workers=False)
    try:
        jm, tm = JM(jstore, **kw), TM(tstore, **kw)
        jm._get_live = lambda: (jstore.get("live_set", timeout_s=2).decode()
                                if jm._has("live_set") else "")
        tm._get_live = lambda: (tm._get("live_set") or b"").decode()
        want = _elastic_script(jm, lambda k, v: jstore.set(k, v.encode()),
                               jstore.delete)
        got = _elastic_script(tm, tstore.set, tstore.delete_key)
        assert got == want
        assert [g for _, g, _ in got] == [0, 0, 0, 0, 1]
        assert got[-1][0] == "n0" and got[-1][2] == ["n1"]
        assert tm.last_heartbeat("ghost") is None
    finally:
        jstore.close()


def test_elastic_manager_threads_bump_the_generation():
    """Three registered managers over one torch store: the master's scan
    thread bumps the generation when node 2 stops beating."""
    from datetime import timedelta

    from torch.distributed import TCPStore

    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    master = TCPStore("127.0.0.1", 0, is_master=True,
                      timeout=timedelta(seconds=10), wait_for_workers=False)
    stores = [master] + [TCPStore("127.0.0.1", master.port,
                                  timeout=timedelta(seconds=10))
                         for _ in range(2)]
    mgrs = [ElasticManager(stores[i], node_id=f"n{i}", is_master=(i == 0),
                           heartbeat_interval_s=0.2, heartbeat_timeout_s=1.0)
            for i in range(3)]
    try:
        for m in mgrs:
            m.join_roster()
            m.register()
        assert mgrs[1].wait_for_np(3, timeout_s=20)
        gen0 = mgrs[1].generation()
        mgrs[1].should_restart()
        assert not mgrs[1].should_restart()
        mgrs[2].exit(completed=False)
        deadline = time.time() + 20
        while time.time() < deadline and mgrs[1].generation() == gen0:
            time.sleep(0.2)
        assert mgrs[1].generation() > gen0
        assert mgrs[1].should_restart()
    finally:
        for m in mgrs:
            m.exit()


# -- the launcher's environment and the build lock ----------------------------

def test_launcher_env_is_a_superset_of_the_jax_pods(tmp_path):
    from paddle_tpu.distributed.launch.main import Pod as JPod
    from paddle_tpu_torch.distributed.launch.main import Pod as TPod

    args = argparse.Namespace(node_rank=0, nnodes=1, nproc_per_node=2,
                              log_dir=str(tmp_path), obs_dir=str(tmp_path),
                              devices=None)
    eps = ["127.0.0.1:1", "127.0.0.1:2"]
    base = set(os.environ)
    want = JPod(args)._env_for(1, 2, "127.0.0.1:29500", eps)
    got = TPod(args)._env_for(1, 2, "127.0.0.1:29500", eps)
    assert set(want) - base <= set(got) - base
    for k in set(want) - base:
        assert got[k] == want[k], k
    assert {k: got[k] for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE", "LOCAL_RANK")} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500", "RANK": "1",
        "WORLD_SIZE": "2", "LOCAL_RANK": "1"}


_BUILD_ONCE = r"""
import importlib.util, sys, time
from pathlib import Path

# the module alone (standard library only), not the package around it
spec = importlib.util.spec_from_file_location("_build", sys.argv[2])
_build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(_build)

d = Path(sys.argv[1])
_build.build_dir = lambda: d
_build.sources = lambda: [d / "fake.cu"]
_build.digest = lambda: "fake"

def fake_build(srcs, out):
    with open(d / "builds", "a") as f:
        f.write("x")
    time.sleep(1.0)
    out.write_bytes(b"lib")
    return "built"

class FakeLib:
    def __getattr__(self, name):
        return type("Fn", (), {})()

_build._build = fake_build
_build.ctypes.CDLL = lambda path: FakeLib()
_build.load_library()
print(_build.last_build["built"])
"""


def test_build_runs_once_across_processes(tmp_path):
    src = os.path.join(ROOT, "paddle_tpu_torch", "ops", "kernels",
                       "_build.py")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONCE,
                               str(tmp_path), src], env=_env(),
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = sorted(p.communicate(timeout=120)[0].strip() for p in procs)
    assert all(p.returncode == 0 for p in procs)
    assert (tmp_path / "builds").read_text() == "x"
    assert outs == ["False", "True"]


def test_init_parallel_env_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    from paddle_tpu_torch.distributed import env

    assert env.choose_backend(torch.device("cpu"), 4, 0) == "gloo"
    assert env.choose_backend(torch.device("cuda", 0), 4, 1) == "gloo"
    assert env.choose_backend(torch.device("cuda", 0), 4, 4) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(env, "_initialized", False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_parallel_env()


# -- drills through the launcher ----------------------------------------------

def test_launch_env_wiring_and_elastic_restart(tmp_path):
    """Two ranks join a gloo world through ``init_parallel_env`` from the
    launcher's env; rank 0 of generation 0 then fails, and ``--elastic``
    relaunches the pod with the generation bumped and a new master
    port."""
    res = _launch(f"""
        import os, sys
        import torch.distributed as dist
        from paddle_tpu_torch.distributed import (ParallelEnv,
                                                  init_parallel_env)
        dev = init_parallel_env(device="cpu")
        e = ParallelEnv()
        gen = os.environ["PADDLE_RESTART_GENERATION"]
        with open(r"{tmp_path}/gen" + gen + "-" + str(e.rank), "w") as f:
            f.write(f"{{e.rank}}/{{e.world_size}}/{{dist.get_backend()}}/"
                    f"{{dev}}/{{os.environ['MASTER_PORT']}}/"
                    f"{{os.environ['PADDLE_CURRENT_ENDPOINT']}}")
        # every rank has written before rank 0 fails (the watcher then
        # ends the pod, rank 1 with it)
        dist.barrier()
        dist.destroy_process_group()
        if gen == "0" and e.rank == 0:
            sys.exit(1)
        """, tmp_path, ["--nproc_per_node", "2", "--elastic",
                        "--max_restarts", "2", "--restart_backoff", "0.1"])
    assert res.returncode == 0, res.stderr
    assert "relaunch 1/2 (generation 1)" in res.stderr
    assert "backend gloo (CPU ranks)" in res.stderr
    got = {(g, r): (tmp_path / f"gen{g}-{r}").read_text().split("/")
           for g in (0, 1) for r in (0, 1)}
    for (g, r), v in got.items():
        assert v[:4] == [str(r), "2", "gloo", "cpu"], (g, r, v)
    assert got[0, 0][5] != got[0, 1][5]      # probed, distinct endpoints
    assert got[0, 0][4] != got[1, 0][4]      # a new master port


def test_launch_propagates_failure(tmp_path):
    res = _launch("""
        import os, sys
        sys.exit(3 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
        """, tmp_path, ["--nproc_per_node", "2"])
    assert res.returncode == 1
    assert "[launch] crash: rank 1: exit code 3" in res.stderr


def test_launch_forwards_sigterm_to_workers(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(f"""
        import os, time
        open(r"{tmp_path}/pid" + os.environ["PADDLE_TRAINER_ID"], "w").write(
            str(os.getpid()))
        time.sleep(120)
        """))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", str(script)], env=_env(),
        cwd=str(tmp_path))
    deadline = time.time() + 60
    while time.time() < deadline and len(
            [f for f in os.listdir(tmp_path) if f.startswith("pid")]) < 2:
        time.sleep(0.1)
    time.sleep(0.2)
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in (0, 1)]
    launcher.send_signal(signal.SIGTERM)
    assert launcher.wait(timeout=60) == 130
    for pid in pids:
        deadline = time.time() + 20
        while time.time() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            os.kill(pid, 9)
            raise AssertionError(f"worker {pid} outlived the launcher")


def test_launch_hang_detected_and_relaunched(tmp_path):
    watcher = os.path.join(ROOT, "paddle_tpu_torch", "distributed",
                           "launch", "watcher.py")
    res = _launch(f"""
        import importlib.util, os, sys, time
        # the watcher module alone (standard library only): no torch import
        spec = importlib.util.spec_from_file_location("watcher", {watcher!r})
        watcher = sys.modules["watcher"] = importlib.util.module_from_spec(
            spec)
        spec.loader.exec_module(watcher)
        watcher.touch_heartbeat(step=7)
        if os.environ["PADDLE_RESTART_GENERATION"] == "0":
            time.sleep(120)
        """, tmp_path, ["--nproc_per_node", "1", "--elastic",
                        "--max_restarts", "1", "--hang_timeout", "1.0",
                        "--restart_backoff", "0.1", "--grace_secs", "1"])
    assert res.returncode == 0, res.stderr
    assert "hang: rank 0: heartbeat stale > 1.0s, last step 7" in res.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rendezvous_retries_injected_failures(tmp_path):
    """Two launcher nodes rendezvous over a TCPStore; the first attempt
    is failed by the injection point and retried with backoff; each
    node's rank learns its global rank and the agreed master."""
    script = tmp_path / "train.py"
    script.write_text(
        "import os\n"
        f"open(r'{tmp_path}/done' + os.environ['PADDLE_NODE_RANK'], 'w')"
        ".write(os.environ['PADDLE_TRAINER_ID'] + ' ' "
        "+ os.environ['PADDLE_MASTER'])\n")
    env = _env(PADDLE_FI_DIR=str(tmp_path / "fi"),
               PADDLE_FI_FAIL_RENDEZVOUS_N="1")
    base = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
            "--nnodes", "2", "--master", f"127.0.0.1:{_free_port()}"]
    procs = [subprocess.Popen(base + ["--node_rank", str(n), str(script)],
                              env=env, cwd=str(tmp_path),
                              stderr=subprocess.PIPE, text=True)
             for n in (0, 1)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    got = [(tmp_path / f"done{n}").read_text().split() for n in (0, 1)]
    assert [g[0] for g in got] == ["0", "1"] and got[0][1] == got[1][1]
    assert "injected rendezvous failure" in "".join(errs)
    assert "retrying in" in "".join(errs)


# A 2-rank trainer (dp=2, fp32, a 1-layer GPT) on the same batches on
# every rank (batch i from seed 500 + i), a checkpoint every SAVE_EVERY
# steps (ASYNC: async, else sync), the preemption guard armed, resuming
# from the newest checkpoint; every step's loss to a trace per
# generation and rank, and rank 0's full params' digest at the end.
DRILL = """
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from paddle_tpu_torch.distributed import consistency as cns
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import hybrid
from paddle_tpu_torch.utils import fault_injection as fi

WORK, STEPS, SAVE_EVERY, ASYNC = {work!r}, {steps}, {save_every}, {async_}
dev = init_parallel_env(device="cpu")
rank = int(os.environ["PADDLE_TRAINER_ID"])
gen = int(os.environ["PADDLE_RESTART_GENERATION"])
cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                max_position_embeddings=64)

class Loader:
    cursor = 0
    def next(self):
        rng = np.random.RandomState(500 + self.cursor)
        self.cursor += 1
        return (rng.randint(0, 128, (4, 16)), rng.randint(0, 128, (4, 16)))
    def state_dict(self):
        return {{"cursor": self.cursor}}
    def load_state_dict(self, sd):
        self.cursor = sd["cursor"]

t = hybrid.HybridParallelTrainer(cfg, hybrid.TrainerConfig(
    dp=2, compute_dtype=torch.float32, learning_rate=1e-3, warmup_steps=2),
    device=dev)
ckpt, loader = os.path.join(WORK, "ckpt"), Loader()
t.enable_preemption_guard(ckpt, dataloader=loader)
start = t.load_checkpoint(ckpt, dataloader=loader) or 0
if rank == 0:
    with open(os.path.join(WORK, f"start-gen{{gen}}"), "w") as f:
        f.write(str(start))
trace = open(os.path.join(WORK, f"trace-gen{{gen}}-rank{{rank}}.jsonl"), "a")

def line(step, loss):
    trace.write(json.dumps({{"step": step, "loss": loss,
                             "cursor": loader.cursor}}) + "\\n")
    trace.flush()

while t.global_step < STEPS:
    step = t.global_step + 1
    try:
        loss = float(t.step(*loader.next()))
    except hybrid.TrainingPreempted as e:
        line(step, float(e.loss))
        raise
    line(step, loss)
    if SAVE_EVERY and step % SAVE_EVERY == 0:
        t.save_checkpoint(ckpt, step, dataloader=loader, async_save=ASYNC)
    fi.at_step(step)
t.flush_checkpoints()
digest = cns.tree_digest64(t.full_params())
if rank == 0:
    with open(os.path.join(WORK, f"result-gen{{gen}}.json"), "w") as f:
        json.dump({{"params": str(digest)}}, f)
"""


def _drill(work, steps=7, save_every=1, async_=False, args=(), **env):
    os.makedirs(work, exist_ok=True)
    script = os.path.join(work, "drill.py")
    with open(script, "w") as f:
        f.write(DRILL.format(work=str(work), steps=steps,
                             save_every=save_every, async_=async_))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--grace_secs", "5", *args, script]
    return subprocess.run(cmd, env=_env(PADDLE_FI_DIR=os.path.join(
        work, "fi"), **env), capture_output=True, text=True, timeout=180,
        cwd=str(work))


def _trace(work, gen, rank=0):
    with open(os.path.join(work, f"trace-gen{gen}-rank{rank}.jsonl")) as f:
        return [json.loads(x) for x in f]


def _result(work, gen):
    with open(os.path.join(work, f"result-gen{gen}.json")) as f:
        return json.load(f)


def test_preemption_then_kill_resume_bit_for_bit(tmp_path):
    """Async saves every 2 steps, ``--elastic --max_restarts 1``.
    Generation 0: rank 0's preemption notice at step 3 is all-reduced,
    both ranks write the just-in-time checkpoint at step 3 and exit 118,
    and the launcher relaunches at once, at no restart budget.
    Generation 1 resumes at step 3 (zero lost steps); rank 1 is SIGKILLed
    after step 6, its async save in flight: the watcher classifies a
    crash, the launcher ends rank 0 and relaunches (budget 1 of 1).
    Generation 2 resumes from the newest step every rank's shard
    completes: 4 (whose commit step 6's save waited for) or 6. Every
    step's loss and data cursor, in every generation and on both ranks,
    and the final params equal the uninterrupted run's bit for bit (that
    run goes beside the drill)."""
    ref_work, work = tmp_path / "reference", tmp_path / "drill"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(_drill, ref_work, save_every=0)
        res = _drill(work, save_every=2, async_=True,
                     args=["--elastic", "--max_restarts", "1",
                           "--restart_backoff", "0.1"],
                     PADDLE_FI_PREEMPT_AT_STEP="3",
                     PADDLE_FI_KILL_AT_STEP="6", PADDLE_FI_KILL_RANK="1")
        ref_res = ref_run.result()
    assert ref_res.returncode == 0, ref_res.stderr[-3000:]
    assert res.returncode == 0, res.stderr[-3000:]
    err = res.stderr
    assert "[launch] preemption:" in err
    assert "no restart budget consumed" in err
    assert err.count("just-in-time checkpoint at step 3") == 2
    assert "[launch] crash: " in err and "rank 1: killed by SIGKILL" in err
    assert "relaunch 1/1 (generation 2)" in err
    by_step = {r["step"]: r for r in _trace(ref_work, 0)}
    for rank in (0, 1):
        steps = []
        for gen in (0, 1, 2):
            for r in _trace(work, gen, rank):
                assert r == by_step[r["step"]], (gen, rank, r)
                steps.append(r["step"])
        resumed = int((work / "start-gen2").read_text())
        assert steps == [1, 2, 3, 4, 5, 6] + list(range(resumed + 1, 8)), (
            rank, steps)
    assert (work / "start-gen1").read_text() == "3"
    assert resumed in (4, 6)
    assert _result(work, 2)["params"] == _result(ref_work, 0)["params"]
