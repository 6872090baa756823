"""The port's asynchronous checkpoints, preemption guard and divergence
rollback on the CPU -- the counterparts of the in-process tests of
``tests/test_preemption_async_ckpt.py``: an async commit lands the same
files as a sync one, its snapshot is isolated from later writes, at most
one save is in flight, a background write error re-raises at the next
save and at ``wait()``, rotation and sweeps never touch the in-flight
directory, a long save touches the launcher heartbeat, the guard chains
the previous signal handler, a notice becomes a just-in-time checkpoint
and exit 118, ``PADDLE_FI_PREEMPT_AT_STEP`` fires once through a real
SIGTERM; then the rollback of a diverging run to its newest checkpoint,
and a two-process drill (preempted after step 1 of 2, relaunched) that
loses no step and ends with the uninterrupted run's params, bitwise."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.utils import preemption as jpreemption
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.utils import preemption
from paddle_tpu_torch.utils.tree import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0, n=4096):
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(8, n // 8).astype(np.float32),
            "b": rng.rand(n // 8).astype(np.float32)}


def test_exit_code_and_exception_match_the_jax_package():
    assert preemption.PREEMPTED_EXIT_CODE == jpreemption.PREEMPTED_EXIT_CODE
    assert thybrid.PREEMPTED_EXIT_CODE == 118
    e = preemption.TrainingPreempted("x", step=3, checkpoint_path="p")
    assert isinstance(e, SystemExit) and e.code == 118 and str(e) == "x"


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_async_commit_identical_to_sync_and_isolated(tmp_path, source):
    """Async changes when the disk work happens, never what lands: the
    same manifest as a sync save, and writes to the source after save()
    returns do not reach the checkpoint."""
    state = _state(seed=3)
    keep = {k: v.copy() for k, v in state.items()}
    if source == "tensor":
        state = {k: torch.from_numpy(v) for k, v in state.items()}
    amgr = ckpt.AsyncCheckpointManager(str(tmp_path / "a"))
    apath = amgr.save(state, 5)
    state["w"][:] = -1.0            # rewrite the source mid-commit
    amgr.wait()
    assert ckpt.verify_checkpoint(apath) == (True, "ok")
    spath = ckpt.CheckpointManager(str(tmp_path / "s")).save(keep, 5)
    assert (open(os.path.join(apath, "manifest-0.json")).read()
            == open(os.path.join(spath, "manifest-0.json")).read())
    loaded = ckpt.load_state_dict(apath)
    for k, v in keep.items():
        np.testing.assert_array_equal(loaded[k], v)


def test_async_backpressure_one_in_flight(tmp_path, monkeypatch):
    real_commit = ckpt._commit_snapshot
    slow = {"delay": 0.3}

    def slow_commit(snapshot, path):
        time.sleep(slow["delay"])
        return real_commit(snapshot, path)

    monkeypatch.setattr(ckpt, "_commit_snapshot", slow_commit)
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path))
    t0 = time.perf_counter()
    mgr.save(_state(0), 1)
    assert time.perf_counter() - t0 < 0.25      # save() returns at once
    assert mgr.in_flight()
    mgr.save(_state(1), 2)                      # waits out step-1's commit
    assert time.perf_counter() - t0 >= slow["delay"]
    slow["delay"] = 0.0
    mgr.finalize()
    assert not mgr.in_flight() and mgr.steps() == [1, 2]
    assert mgr.last_commit_s is not None


def test_async_write_error_reraises_at_next_save_and_wait(tmp_path,
                                                          monkeypatch):
    calls = {"n": 0}
    real_commit = ckpt._commit_snapshot

    def failing_commit(snapshot, path):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(28, "No space left on device")
        return real_commit(snapshot, path)

    monkeypatch.setattr(ckpt, "_commit_snapshot", failing_commit)
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path))
    mgr.save(_state(0), 1)
    with pytest.raises(ckpt.CheckpointError, match="No space left"):
        mgr.save(_state(1), 2)
    mgr.save(_state(1), 2)              # the error was consumed
    mgr.wait()
    assert mgr.steps() == [2]
    calls["n"] = 0
    mgr.save(_state(2), 3)
    with pytest.raises(ckpt.CheckpointError, match="async checkpoint"):
        mgr.wait()


def test_sweep_and_rotation_never_touch_in_flight_dir(tmp_path,
                                                      monkeypatch):
    real_commit = ckpt._commit_snapshot
    gate = threading.Event()

    def gated_commit(snapshot, path):
        os.makedirs(path + ckpt._STAGING_SUFFIX, exist_ok=True)
        gate.wait(timeout=10)
        return real_commit(snapshot, path)

    monkeypatch.setattr(ckpt, "_commit_snapshot", gated_commit)
    amgr = ckpt.AsyncCheckpointManager(str(tmp_path), keep_last_n=1)
    amgr.save(_state(0), 9)
    staging = amgr.step_dir(9) + ckpt._STAGING_SUFFIX
    deadline = time.time() + 10
    while not os.path.isdir(staging) and time.time() < deadline:
        time.sleep(0.01)
    assert os.path.isdir(staging)
    monkeypatch.setattr(ckpt, "_commit_snapshot", real_commit)
    other = ckpt.CheckpointManager(str(tmp_path), keep_last_n=1)
    other._sweep_stale_staging()
    other._rotate()
    assert os.path.isdir(staging)       # survived
    gate.set()
    amgr.wait()
    assert amgr.steps() == [9]
    assert ckpt.verify_checkpoint(amgr.step_dir(9)) == (True, "ok")


def test_heartbeat_touched_during_save(tmp_path, monkeypatch):
    hb = tmp_path / "hb"
    hb.write_text(json.dumps({"step": 41}))
    stale = time.time() - 1000
    os.utime(hb, (stale, stale))
    monkeypatch.setenv("PADDLE_HEARTBEAT_FILE", str(hb))
    ckpt.save_state_dict(_state(), str(tmp_path / "ckpt"))
    assert time.time() - os.path.getmtime(hb) < 100
    assert json.loads(hb.read_text())["step"] == 41


def test_preemption_guard_chains_previous_handler():
    ran = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: ran.append(s))
    guard = preemption.PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not guard.preemption_noticed() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.preemption_noticed()
        assert ran == [signal.SIGUSR1]
        assert guard.why == "signal SIGUSR1"
    finally:
        guard.uninstall()
        signal.signal(signal.SIGUSR1, prev)
    assert signal.getsignal(signal.SIGUSR1) is prev


def _trainer(**kw):
    return thybrid.HybridParallelTrainer(
        gpt_tiny(), thybrid.TrainerConfig(compute_dtype=torch.float32, **kw),
        device="cpu")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (2, 16)), rng.randint(0, 1024, (2, 16)))


def test_preemption_notice_writes_jit_checkpoint_and_exits(tmp_path):
    t = _trainer()
    root = str(tmp_path / "ckpt")
    guard = t.enable_preemption_guard(
        root, guard=preemption.PreemptionGuard(install=False))
    t.step(*_batch())
    t.save_checkpoint(root, 1, async_save=True)     # flushed before the JIT
    guard.notify("test notice")
    with pytest.raises(preemption.TrainingPreempted) as ei:
        t.step(*_batch(1))
    e = ei.value
    assert e.code == 118 and e.step == 2
    assert e.loss is not None and np.isfinite(float(e.loss))
    assert ckpt.verify_checkpoint(e.checkpoint_path) == (True, "ok")
    t2 = _trainer()
    assert t2.load_checkpoint(root) == 2 and t2.global_step == 2
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(t.params), flatten(t2.params)))


def test_preemption_via_fault_injection_signal(tmp_path, monkeypatch):
    """``PADDLE_FI_PREEMPT_AT_STEP`` sends a real SIGTERM through the
    guard's handler at the boundary after the armed step; the marker
    file keeps a second trainer in the same environment from firing."""
    monkeypatch.setenv("PADDLE_FI_DIR", str(tmp_path / "fi"))
    monkeypatch.setenv("PADDLE_FI_PREEMPT_AT_STEP", "2")
    t = _trainer()
    guard = t.enable_preemption_guard(str(tmp_path / "ckpt"))
    try:
        with pytest.raises(preemption.TrainingPreempted) as ei:
            for i in range(4):
                t.step(*_batch(i))
        assert ei.value.step == 2
        assert "SIGTERM" in (guard.why or "")
        t2 = _trainer()
        g2 = t2.enable_preemption_guard(str(tmp_path / "ckpt2"))
        try:
            for i in range(3):
                t2.step(*_batch(i))
        finally:
            g2.uninstall()
        assert t2.global_step == 3
    finally:
        guard.uninstall()


def test_preempt_at_step_needs_its_marker_dir(monkeypatch, capsys):
    from paddle_tpu_torch.utils import fault_injection as fi

    monkeypatch.delenv("PADDLE_FI_DIR", raising=False)
    monkeypatch.setenv("PADDLE_FI_PREEMPT_AT_STEP", "5")
    assert not fi.preempt_at_step(5)
    assert "PADDLE_FI_DIR is required" in capsys.readouterr().err
    monkeypatch.setenv("PADDLE_FI_PREEMPT_AT_STEP", "5+")
    assert not fi.preempt_at_step(5)
    assert "malformed" in capsys.readouterr().err


def test_divergence_rolls_back_to_the_newest_checkpoint(tmp_path,
                                                        monkeypatch):
    t = _trainer(max_consecutive_skips=2)
    for i in range(2):
        t.step(*_batch(i))
    t.save_checkpoint(str(tmp_path), t.global_step)
    saved = {k: v.clone() for k, v in flatten(t.params)}
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "3,4")
    with pytest.raises(thybrid.NumericalDivergenceError,
                       match="rolled back to checkpoint step 2") as ei:
        for i in range(2, 6):
            t.step(*_batch(i))
    assert ei.value.rolled_back_to == 2
    assert ei.value.exit_code == thybrid.DIVERGENCE_EXIT_CODE
    assert t.global_step == 2
    assert all(torch.equal(saved[k], v) for k, v in flatten(t.params))
    assert t.anomaly["consecutive"] == 0


_WORKER = r"""
import json, sys
import numpy as np, torch
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.parallel import hybrid
from paddle_tpu_torch.utils.tree import flatten

root, out, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])


class Loader:
    cursor = 0

    def next(self):
        rng = np.random.RandomState(100 + self.cursor)
        self.cursor += 1
        return rng.randint(0, 1024, (2, 16)), rng.randint(0, 1024, (2, 16))

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, sd):
        self.cursor = sd["cursor"]


t = hybrid.HybridParallelTrainer(
    gpt_tiny(), hybrid.TrainerConfig(compute_dtype=torch.float32),
    device="cpu")
loader = Loader()
if root != "-":
    t.enable_preemption_guard(root, dataloader=loader)
    start = t.load_checkpoint(root, dataloader=loader) or 0
else:
    start = 0
while t.global_step < steps:
    t.step(*loader.next())
    if root != "-":
        t.save_checkpoint(root, t.global_step, dataloader=loader,
                          async_save=True)
t.flush_checkpoints()
np.savez(out, **{"/".join(k): v.numpy() for k, v in flatten(t.params)})
print(json.dumps({"resumed_at": start, "cursor": loader.cursor}))
"""


def test_two_process_preemption_drill_loses_no_step(tmp_path):
    root, fi_dir = str(tmp_path / "ckpt"), str(tmp_path / "fi")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               PADDLE_FI_PREEMPT_AT_STEP="1", PADDLE_FI_DIR=fi_dir)

    def run(root_arg, out):
        return subprocess.run(
            [sys.executable, "-c", _WORKER, root_arg, out, "2"], env=env,
            cwd=ROOT, capture_output=True, text=True, timeout=300)

    first = run(root, str(tmp_path / "a.npz"))
    assert first.returncode == 118, first.stderr[-2000:]
    assert "just-in-time checkpoint" in first.stderr
    assert ckpt.verify_checkpoint(os.path.join(root, "step-1"))[0]
    second = run(root, str(tmp_path / "b.npz"))
    assert second.returncode == 0, second.stderr[-2000:]
    assert json.loads(second.stdout.splitlines()[-1]) == {"resumed_at": 1,
                                                         "cursor": 2}
    ref = run("-", str(tmp_path / "ref.npz"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    got, want = np.load(tmp_path / "b.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
