"""The port's replica fleet against the JAX package's on the CPU, in one
process: the five cases of the JAX fleet tests. One virtual-clock script
drives each package's router over replicas of a tiny GPT with shared
weights, and the router snapshots (the wall-timed tick EMA and the score
built on it left out), the statuses and the delivered tokens must be
equal: the membership lifecycle (healthy, overloaded, draining, dead,
recovered), the cancel and the deadline expiry of a re-dispatched
request, threaded replicas, and the router drill's legs (a replica
killed mid-decode and one wedged, through the fault points; a rolling
restart under load; typed retries under overload). Besides, the
scheduler's graceful drain against the JAX scheduler's, and the drain
guard's exit 118 in a worker process that is then relaunched."""
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.engine import ServingConfig, ServingEngine
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
             max_position_embeddings=64, hidden_dropout=0.0,
             attention_dropout=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.GPTConfig(**_TINY))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.GPTConfig(**_TINY)
    tm = TM.GPTForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm


def _side(models, which):
    jm, tm = models
    if which == "jax":
        return types.SimpleNamespace(
            model=jm, Engine=JEngine, Config=JConfig, sched=jsched,
            replica=jreplica, router=jrouter)
    return types.SimpleNamespace(
        model=tm, Engine=ServingEngine, Config=ServingConfig, sched=tsched,
        replica=treplica, router=trouter)


def _both(models, script, **kw):
    """``script(side, **kw)`` for each package: (jax, torch)."""
    return tuple(script(_side(models, w), **kw) for w in ("jax", "torch"))


def _engine(side, **kw):
    base = dict(page_size=8, max_model_len=64, max_batch=8,
                max_prefill_tokens=128)
    base.update(kw)
    return side.Engine(side.model, side.Config(**base))


def _p(n, seed=0):
    return ((np.arange(n) * 7 + seed * 13) % 64).astype(np.int32)


class VClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class CreepClock:
    """Moves a hair on every read: ages and EMAs move, and a test can
    still jump it past a stall threshold."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _replica(side, name, clk, **sched_kw):
    return side.replica.Replica(
        name, make_engine=lambda: _engine(side),
        make_scheduler=lambda eng: side.sched.ContinuousBatchingScheduler(
            eng, clock=clk, **sched_kw),
        clock=clk)


def _router(side, replicas, clk, **cfg_kw):
    base = dict(probe_interval_s=0.0, breaker_failures=1,
                breaker_reset_s=0.5)
    base.update(cfg_kw)
    return side.router.ReplicaRouter(replicas, clock=clk,
                                     cfg=side.router.RouterConfig(**base))


def _snap(router):
    """The router's snapshot without the wall-timed fields."""
    snap = router.snapshot()
    for r in snap["replicas"].values():
        r.pop("tick_s_ema")
        r.pop("score")
    return snap


def _journal(lrs):
    return {lr.rid: (lr.status, list(lr.delivered), lr.redispatches)
            for lr in lrs}


# -- membership lifecycle -------------------------------------------------

def _lifecycle(side):
    clk = VClock()
    rep = _replica(side, "a", clk, max_waiting=1)
    router = _router(side, [rep], clk)
    m = router.members["a"]
    seen = [(m.membership, m.breaker)]
    lr = router.submit_request(side.router.LogicalRequest(
        rid=1, prompt=_p(6), max_new_tokens=4))
    router.pump()
    clk.t += 0.01
    router.pump()
    seen.append((m.membership, m.ready(), lr.status))
    m.draining = True
    clk.t += 0.01
    router.pump()
    seen.append((m.membership, m.ready()))
    m.draining = False
    rep.kill()
    clk.t += 0.01
    router.pump()
    seen.append((m.membership, m.breaker, lr.status, lr.redispatches))
    with pytest.raises(side.replica.ReplicaDown):
        rep.health()
    rep.restart()
    clk.t += 1.0
    router.pump()
    seen.append((m.breaker, "recovered" in m.history))
    router.run_until_done()
    return (seen, _journal([lr]), _snap(router), rep.engine.pool.in_use)


def test_membership_full_lifecycle_matches_jax(models):
    want, got = _both(models, _lifecycle)
    assert got == want
    seen, journal, snap, in_use = got
    assert seen[1][:2] == ("overloaded", False)
    assert seen[2] == ("draining", False)
    assert seen[3] == ("dead", "open", "pending", 1)
    assert seen[4] == ("closed", True)
    assert journal[1][0] == "finished" and len(journal[1][1]) == 4
    it = iter(snap["replicas"]["a"]["history"])
    assert all(s in it for s in ("healthy", "overloaded", "draining",
                                 "dead", "recovered"))
    assert in_use == 0


# -- cancel / deadline of a re-dispatched request ---------------------------

def _wedge_and_redispatch(side, clk, max_new=24, deadline_s=None):
    a = _replica(side, "a", clk)
    b = _replica(side, "b", clk)
    router = _router(side, [a, b], clk)
    lr = router.submit_request(side.router.LogicalRequest(
        rid=1, prompt=_p(6), max_new_tokens=max_new, deadline_s=deadline_s))
    router.pump()
    assert lr.replica == "a"
    for _ in range(3):
        a.tick()
    router.pump()
    assert len(lr.delivered) > 0
    a.wedge(3600.0)
    clk.t += 0.01
    router.pump()
    assert a.engine.pool.in_use == 0
    assert lr.replica == "b" and lr.redispatches == 1
    b.tick()
    assert b.engine.pool.in_use > 0
    return router, a, b, lr


def _cancel(side):
    clk = VClock()
    router, a, b, lr = _wedge_and_redispatch(side, clk)
    first, second = router.cancel(1), router.cancel(1)
    return (first, second, _journal([lr]), _snap(router),
            a.engine.pool.in_use, b.engine.pool.in_use,
            [c.rid for c in router.completed])


def test_cancel_redispatched_request_matches_jax(models):
    want, got = _both(models, _cancel)
    assert got == want
    first, second, journal, _, a_use, b_use, done = got
    assert first and not second and done == [1]
    assert journal[1][0] == "cancelled" and journal[1][2] == 1
    assert a_use == b_use == 0


def _deadline(side):
    clk = VClock()
    router, a, b, lr = _wedge_and_redispatch(side, clk, deadline_s=100.0)
    clk.t += 500.0
    b.tick()
    router.pump()
    return (_journal([lr]), _snap(router), a.engine.pool.in_use,
            b.engine.pool.in_use, [c.rid for c in router.completed])


def test_deadline_expiry_of_redispatched_request_matches_jax(models):
    want, got = _both(models, _deadline)
    assert got == want
    journal, _, a_use, b_use, done = got
    assert journal[1][0] == "timeout" and done == [1]
    assert 0 < len(journal[1][1]) < 24
    assert a_use == b_use == 0


# -- threaded fleet -----------------------------------------------------------

def _reference(side, prompts, max_new):
    """One scheduler's greedy streams: what the fleet must deliver."""
    s = side.sched.ContinuousBatchingScheduler(_engine(side))
    for i, p in enumerate(prompts):
        s.submit(side.sched.Request(rid=i, prompt=p.copy(),
                                    max_new_tokens=max_new))
    s.run()
    return {r.rid: list(r.generated) for r in s.finished}


def test_threaded_fleet_smoke(models):
    """Two port replicas on their own tick threads, the router pumping
    from the caller: every request finishes with the JAX scheduler's
    stream, and the pools drain."""
    prompts = [_p(6, i) for i in range(4)]
    want = _reference(_side(models, "jax"), prompts, 8)
    side = _side(models, "torch")
    reps = [side.replica.Replica(n, make_engine=lambda: _engine(side))
            .start() for n in ("a", "b")]
    try:
        router = side.router.ReplicaRouter(
            reps, cfg=side.router.RouterConfig(probe_interval_s=0.005))
        lrs = [router.submit_request(side.router.LogicalRequest(
            rid=i, prompt=p, max_new_tokens=8))
            for i, p in enumerate(prompts)]
        deadline = time.monotonic() + 120.0
        while router.in_flight:
            router.pump()
            time.sleep(0.002)
            assert time.monotonic() < deadline, router.snapshot()
        assert {lr.rid: list(lr.delivered) for lr in lrs} == want
        assert all(lr.status == "finished" for lr in lrs)
        snap = router.snapshot()
        assert snap["replicas_up"] == 2 and snap["replicas_dead"] == 0
    finally:
        for r in reps:
            r.stop()
    assert all(r.engine.pool.in_use == 0 for r in reps)
    assert not any(r.threaded for r in reps)


# -- the router drill, in process ----------------------------------------------

def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 64, 8).astype(np.int32) for _ in range(6)]


def _fleet(side, names, clk, make_sched=None, **router_kw):
    reps = [side.replica.Replica(
        n, make_engine=lambda: _engine(side), make_scheduler=make_sched,
        clock=clk) for n in names]
    return reps, _router(side, reps, clk, **router_kw)


def _logicals(side, n=6, max_new=16):
    prompts = _prompts()
    return [side.router.LogicalRequest(rid=i, prompt=prompts[i % 6].copy(),
                                       max_new_tokens=max_new)
            for i in range(n)]


def _drill_kill(side, fi_dir, monkeypatch):
    monkeypatch.setenv("PADDLE_FI_DIR", fi_dir)
    monkeypatch.setenv("PADDLE_FI_ROUTER_KILL_REPLICA", "a0:4")
    clk = CreepClock()
    (a0, a1), router = _fleet(side, ["a0", "a1"], clk)
    lrs = _logicals(side)
    for lr in lrs:
        router.submit_request(lr)
    router.run_until_done()
    monkeypatch.delenv("PADDLE_FI_ROUTER_KILL_REPLICA")
    return (_journal(lrs), _snap(router), a0.state, a0.engine,
            a1.engine.pool.in_use)


def _drill_wedge(side, fi_dir, monkeypatch):
    monkeypatch.setenv("PADDLE_FI_DIR", fi_dir)
    monkeypatch.setenv("PADDLE_FI_ROUTER_WEDGE_REPLICA", "b0:3:3600")
    clk = CreepClock()
    (b0, b1), router = _fleet(side, ["b0", "b1"], clk)
    lrs = _logicals(side)
    for lr in lrs:
        router.submit_request(lr)
    for _ in range(4):
        router.pump()
        b0.tick()
        b1.tick()
    monkeypatch.delenv("PADDLE_FI_ROUTER_WEDGE_REPLICA")
    victims = [lr.rid for lr in lrs if lr.replica == "b0"]
    clk.t += b0.scheduler.stall_threshold_s + 1.0
    b1.tick()
    wedged = b0.health()["wedged"]
    router.pump()
    after = (_snap(router), b0.engine.pool.in_use)
    placed_on_b0 = [lr.rid for lr in lrs
                    if not lr._finalized and lr.replica == "b0"]
    router.run_until_done()
    return (victims, wedged, after, placed_on_b0, _journal(lrs),
            _snap(router))


@pytest.mark.parametrize("leg", ["kill", "wedge"])
def test_router_drill_chaos_legs_match_jax(models, tmp_path, monkeypatch,
                                           leg):
    """Leg (a): replica a0 dies at its tick 4 (``router_kill_replica``)
    and its work re-dispatches; leg (b): b0 wedges at its tick 3
    (``router_wedge_replica``), reads wedged past the stall threshold,
    and its victims re-dispatch with their pages freed at once. Every
    request finishes with the single-scheduler stream, and the port's
    run equals the JAX run."""
    script = {"kill": _drill_kill, "wedge": _drill_wedge}[leg]
    want = script(_side(models, "jax"), str(tmp_path / "jax"), monkeypatch)
    got = script(_side(models, "torch"), str(tmp_path / "torch"),
                 monkeypatch)
    ref = _reference(_side(models, "torch"), _prompts(), 16)
    if leg == "kill":
        journal, snap, state, engine, a1_use = got
        assert (journal, snap, state, a1_use) == (want[0], want[1],
                                                  want[2], want[4])
        assert state == "dead" and engine is None
        assert snap["replicas_dead"] == 1 and snap["re_dispatches"] > 0
        assert "dead" in snap["replicas"]["a0"]["history"]
        assert a1_use == 0
    else:
        assert got == want
        victims, wedged, (snap, b0_use), placed, journal, _ = got
        assert victims and wedged and b0_use == 0 and not placed
        assert snap["re_dispatches"] >= len(victims)
        assert snap["replicas"]["b0"]["breaker"] != "closed"
    assert {r: d for r, (s, d, _) in journal.items()} == ref
    assert all(s == "finished" for s, _, _ in journal.values())


def test_router_drill_rolling_restart_and_overload(models):
    """Leg (c): a rolling restart while a client keeps submitting loses
    nothing, and both replicas come back a generation older with empty
    pools; leg (d): twice the load a bounded queue holds sheds with
    typed hints that the router's retry honours (never faster than the
    hint's floor, never more than ``max_retries``), and every request
    that finishes carries the single-scheduler stream. Placement and
    retry times follow the wall-timed tick EMA, so these legs hold the
    port to invariants and streams rather than to the JAX run's
    placement."""
    side = _side(models, "torch")
    ref12 = _reference(side, _prompts(), 12)
    clk = CreepClock()
    (c0, c1), router = _fleet(side, ["c0", "c1"], clk)
    load = _logicals(side, n=10, max_new=12)
    feed = iter(load)
    for _ in range(4):
        router.submit_request(next(feed))

    def on_round():
        nxt = next(feed, None)
        if nxt is not None:
            router.submit_request(nxt)

    rr = router.rolling_restart(grace_s=30.0, on_round=on_round)
    for nxt in feed:
        router.submit_request(nxt)
    router.run_until_done()
    assert all(lr.status == "finished" for lr in load)
    assert all(list(lr.delivered) == ref12[lr.rid % 6] for lr in load)
    assert c0.generation == c1.generation == 1
    assert all(v["drained"]["pages_in_use"] == 0 for v in rr.values())
    assert c0.engine.pool.in_use == c1.engine.pool.in_use == 0

    ref8 = _reference(side, _prompts(), 8)
    clk = CreepClock()
    (d0,), router = _fleet(
        side, ["d0"], clk, max_retries=6,
        make_sched=lambda eng: side.sched.ContinuousBatchingScheduler(
            eng, clock=clk, max_waiting=2))
    lrs = _logicals(side, n=16, max_new=8)
    delays = []
    backoff = router._backoff

    def spy(lr, e, now):
        backoff(lr, e, now)
        if lr._retry_at is not None and not lr._finalized:
            delays.append((lr._retry_at - now, e.retry_after_s))

    router._backoff = spy
    for lr in lrs:
        router.submit_request(lr)
    router.run_until_done()
    done = [lr for lr in lrs if lr.status == "finished"]
    shed = [lr for lr in lrs if lr.status == "rejected"]
    assert router.retries > 0 and done and len(done) + len(shed) == 16
    assert all(lr.reject_reason for lr in shed)
    assert all(lr.attempts <= 6 for lr in lrs)
    assert delays and all(d >= 0.9 * h - 1e-9 for d, h in delays)
    assert all(list(lr.delivered) == ref8[lr.rid % 6] for lr in done)
    assert d0.engine.pool.in_use == 0


# -- graceful drain and the drain guard ---------------------------------------

class AutoClock:
    def __init__(self, dt=0.05):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _drain(side, grace):
    eng = _engine(side)
    s = side.sched.ContinuousBatchingScheduler(eng, clock=AutoClock())
    reqs = [side.sched.Request(rid=0, prompt=_p(8), max_new_tokens=1),
            side.sched.Request(rid=1, prompt=_p(8, 1), max_new_tokens=50
                               if grace < 10 else 12),
            side.sched.Request(rid=2, prompt=_p(6, 2), max_new_tokens=6)]
    for r in reqs:
        s.submit(r)
    summary = s.drain(grace_s=grace)
    with pytest.raises(side.sched.RejectedError) as ei:
        s.submit(side.sched.Request(rid=3, prompt=_p(8, 3),
                                    max_new_tokens=4))
    return (summary, [(r.status, list(r.generated)) for r in reqs],
            ei.value.reason, s._health_snapshot()["draining"],
            eng.pool.in_use)


@pytest.mark.parametrize("grace", [1.0, 60.0])
def test_drain_matches_jax(models, grace):
    want, got = _both(models, _drain, grace=grace)
    assert got == want
    summary, statuses, reason, draining, in_use = got
    assert reason == "draining" and draining and in_use == 0
    assert summary["completed"] + summary["cancelled"] == 3
    assert (summary["cancelled"] > 0) == (grace < 10)


_DRAIN_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      ServingConfig, ServingEngine,
                                      synthetic_trace)
from paddle_tpu_torch.utils.preemption import TrainingPreempted

work, gen = sys.argv[1], sys.argv[2]
cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                max_position_embeddings=64, hidden_dropout=0.0,
                attention_dropout=0.0)
model = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
engine = ServingEngine(model, ServingConfig(
    page_size=8, max_model_len=64, max_batch=8, max_prefill_tokens=128))
sched = ContinuousBatchingScheduler(engine)
sched.enable_drain_guard(grace_s=60.0)
for req in synthetic_trace(10, seed=3, prompt_lens=(4, 12),
                           short_out=(6, 12), long_out=(16, 24),
                           vocab_size=cfg.vocab_size):
    sched.submit(req)

def write_result():
    by = {}
    for r in sched.finished:
        by[r.status] = by.get(r.status, 0) + 1
    with open(os.path.join(work, "result-gen%s.json" % gen), "w") as f:
        json.dump({"statuses": by, "pages_in_use": engine.pool.in_use,
                   "drained": sched._drained, "ticks": sched._steps,
                   "tokens": {r.rid: r.generated for r in sched.finished
                              if r.status == "finished"}}, f)

try:
    while sched.has_work:
        sched.step()
except TrainingPreempted:
    write_result()
    raise
write_result()
"""


def test_drain_guard_exits_118_and_the_relaunch_finishes(tmp_path):
    """``PADDLE_FI_PREEMPT_AT_STEP=3`` preempts a serving worker: the
    drain guard drains at the next tick boundary (every in-flight
    request finishes, none is cancelled, no page stays in use) and the
    process exits 118; its relaunch (the marker keeps it from firing
    again) serves the whole trace to the same tokens."""
    env = dict(os.environ, PADDLE_FI_PREEMPT_AT_STEP="3",
               PADDLE_FI_DIR=str(tmp_path / "fi"), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    codes = []
    for gen in ("0", "1"):
        p = subprocess.run([sys.executable, "-c", _DRAIN_WORKER,
                            str(tmp_path), gen], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        codes.append(p.returncode)
        assert p.returncode in (0, 118), p.stderr[-3000:]
    assert codes == [118, 0]
    first, second = (json.loads((tmp_path / f"result-gen{g}.json")
                                .read_text()) for g in "01")
    assert first["drained"] and first["ticks"] > 3
    assert first["statuses"] == {"finished": 10}
    assert first["pages_in_use"] == 0 and second["pages_in_use"] == 0
    assert second["statuses"] == {"finished": 10} and not second["drained"]
    assert second["tokens"] == first["tokens"]


# -- the serving fault points ---------------------------------------------------

def _serve_faults(side, scope):
    eng = _engine(side, num_pages=16)
    s = side.sched.ContinuousBatchingScheduler(eng, clock=VClock())
    s.fi_scope = scope
    reserved = eng.pool.in_use
    reqs = [side.sched.Request(rid=i, prompt=_p(8, i), max_new_tokens=8)
            for i in range(3)]
    for r in reqs:
        s.submit(r)
    s.run()
    return (reserved, [(r.status, list(r.generated)) for r in reqs],
            eng.pool.in_use)


@pytest.mark.parametrize("scope", ["a", "b"])
def test_serve_fault_points_match_jax(models, monkeypatch, scope):
    """``PADDLE_FI_SERVE_NAN_AT_TICK="a@2:1"`` poisons rid 1's logits at
    tick 2 on replica a only (the anomaly guard fails that request
    alone), ``PADDLE_FI_SERVE_SLOW_TICK`` stretches a tick, and
    ``PADDLE_FI_SERVE_POOL_PRESSURE=4`` reserves 4 pages: the same
    outcome as the JAX scheduler's."""
    monkeypatch.setenv("PADDLE_FI_SERVE_NAN_AT_TICK", "a@2:1")
    monkeypatch.setenv("PADDLE_FI_SERVE_SLOW_TICK", "a@3")
    monkeypatch.setenv("PADDLE_FI_SERVE_SLOW_SECS", "0.001")
    monkeypatch.setenv("PADDLE_FI_SERVE_POOL_PRESSURE", "4")
    want, got = _both(models, _serve_faults, scope=scope)
    assert got == want
    reserved, streams, in_use = got
    assert reserved == 4 and in_use == 4
    statuses = [s for s, _ in streams]
    assert statuses == (["finished", "error", "finished"] if scope == "a"
                        else ["finished"] * 3)
