"""Multi-tenant serving in the port against the JAX package on the CPU:
the token bucket's refill and exact retry hints, virtual-time fair
queuing without banked credit, the registry's resolution and
validation, the scheduler's tenant gates (``tenant_quota`` before the
bucket is debited, ``tenant_rate`` with the refill time as its hint),
the one ``max_waiting`` predicate, priority preemption that never takes
a tenant below its floor while preempted output resumes identical, the
billed tenant riding the router's journal across a re-dispatch, and the
``/healthz`` tenants block and the keyed ``/slo?tenant=`` view. Where
both packages run, the port's hints, picks, streams and accounting
equal the JAX package's exactly."""
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.observability import slo as jslo
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import tenancy as jten
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving import tenancy as tten
from paddle_tpu_torch.serving.engine import ServingConfig, ServingEngine
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

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
            ten=jten, slo=jslo, replica=jreplica, router=jrouter)
    return types.SimpleNamespace(
        model=tm, Engine=ServingEngine, Config=ServingConfig, sched=tsched,
        ten=tten, slo=tslo, replica=treplica, router=trouter)


def _both(models, script, **kw):
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


def _run(sched):
    while sched.has_work:
        sched.step()


# -- token bucket and registry (pure host state) ------------------------------

def _bucket_script(ten):
    out = []
    for args in ((0.0, 10.0), (10.0, -1.0)):
        with pytest.raises(ValueError):
            ten.TokenBucket(*args)
    b = ten.TokenBucket(10.0, 40.0)
    out.append(b.try_take(40.0, 0.0))
    out.append(b.try_take(1.0, 0.0))
    out += [b.peek(0.0), b.peek(2.0), b.peek(100.0)]
    out.append(b.try_take(40.0, 100.0))
    ok, retry = b.try_take(16.0, 100.8)
    out.append((ok, retry))
    out.append(b.try_take(16.0, 100.8 + retry + 1e-6))
    out.append(b.peek(100.8 + retry + 1e-6))
    return out


def test_token_bucket_refill_burst_and_exact_hint():
    got = _bucket_script(tten)
    assert got == _bucket_script(jten)
    assert got[0] == (True, 0.0) and got[1][0] is False
    assert got[1][1] == pytest.approx(0.1)
    assert got[2:5] == [0.0, pytest.approx(20.0), 40.0]
    assert got[6][0] is False and got[6][1] == pytest.approx(0.8)
    assert got[7][0] is True and got[8] == pytest.approx(0.0, abs=1e-4)


def _wfq_script(ten):
    reg = ten.TenantRegistry([ten.Tenant("a", weight=2.0),
                              ten.Tenant("b", weight=1.0)])

    def pick(names):
        w = min(names, key=lambda n: (reg.tenants[n].vtime, n))
        reg.note_pick(w)
        reg.charge(w, 10)
        return w

    first = [pick(["b"]) for _ in range(50)]
    return first, [pick(["a", "b"]) for _ in range(30)], reg.snapshot()


def test_wfq_skewed_arrival_converges_without_banked_credit():
    first, picks, snap = _wfq_script(tten)
    assert (first, picks, snap) == _wfq_script(jten)
    assert snap["b"]["vtime"] >= 500.0 and set(first) == {"b"}
    counts = {n: picks.count(n) for n in ("a", "b")}
    assert counts["b"] >= 8
    assert 1.5 <= counts["a"] / counts["b"] <= 2.5


def test_registry_resolve_strict_and_validation():
    for ten in (tten, jten):
        reg = ten.TenantRegistry([ten.Tenant("acme")])
        assert reg.resolve(None).name == ten.DEFAULT_TENANT == "default"
        assert reg.resolve("ghost").name == "ghost"
        with pytest.raises(ValueError):
            reg.register(ten.Tenant("acme"))
        strict = ten.TenantRegistry([ten.Tenant("acme")], strict=True)
        with pytest.raises(KeyError):
            strict.resolve("typo")
        for kw in (dict(weight=0.0), dict(guaranteed_pages=-1),
                   dict(max_resident_pages=2, guaranteed_pages=4)):
            with pytest.raises(ValueError):
                ten.Tenant("x", **kw)
        floored = ten.TenantRegistry([ten.Tenant("g", guaranteed_pages=10)])
        with pytest.raises(ValueError, match="guaranteed_pages"):
            floored.validate(pool_capacity=13, max_pages_per_seq=8)
        floored.validate(pool_capacity=18, max_pages_per_seq=8)
        ten.TenantRegistry().validate(pool_capacity=4, max_pages_per_seq=8)
    assert tten.Tenant("t", rate_tokens_per_s=5.0).bucket.burst == 10.0


# -- the scheduler's tenant gates --------------------------------------------

def _gates(side):
    clk = VClock()
    reg = side.ten.TenantRegistry([side.ten.Tenant(
        "t", rate_tokens_per_s=50.0, burst_tokens=40.0, max_concurrent=2)])
    sched = side.sched.ContinuousBatchingScheduler(_engine(side), clock=clk,
                                                   tenancy=reg)

    def mk(rid):
        return side.sched.Request(rid=rid, prompt=_p(8), max_new_tokens=8,
                                  tenant="t")

    out = []
    sched.submit(mk(0))
    sched.submit(mk(1))
    with pytest.raises(side.sched.RejectedError) as ei:
        sched.submit(mk(2))
    out.append((ei.value.reason, ei.value.tenant,
                reg.tenants["t"].bucket.level))
    _run(sched)
    sched._tick_s_ema = 1e-3               # the hint's floor, fixed
    with pytest.raises(side.sched.RejectedError) as ei:
        sched.submit(mk(3))
    hint = ei.value.retry_after_s
    out.append((ei.value.reason, ei.value.tenant, hint))
    clk.t += hint
    sched.submit(mk(4))
    _run(sched)
    out.append(reg.snapshot())
    out.append({r.rid: (r.status, r.generated) for r in sched.finished})
    out.append(sched.engine.pool.in_use)
    return out


def test_tenant_quota_and_rate_sheds_match_jax(models):
    want, got = _both(models, _gates)
    assert got == want
    assert got[0] == ("tenant_quota", "t", pytest.approx(8.0))
    assert got[1][:2] == ("tenant_rate", "t")
    assert got[1][2] == pytest.approx((16.0 - 8.0) / 50.0)
    assert got[2]["t"]["admitted"] == 3
    assert got[2]["t"]["rejected"] == {"tenant_quota": 1, "tenant_rate": 1}
    assert got[4] == 0


def test_queue_full_single_predicate(models):
    """At every queue depth the ``overloaded`` readiness and the
    submit-time ``queue_full`` shed agree, tenancy on or off."""
    side = _side(models, "torch")
    for tenancy in (None, side.ten.TenantRegistry()):
        sched = side.sched.ContinuousBatchingScheduler(
            _engine(side), clock=VClock(), max_waiting=2, tenancy=tenancy)
        for rid in range(4):
            full = sched._queue_full()
            assert sched.overloaded == full == (len(sched.waiting) >= 2)
            if full:
                with pytest.raises(side.sched.RejectedError) as ei:
                    sched.submit(side.sched.Request(
                        rid=rid, prompt=_p(4), max_new_tokens=4))
                assert ei.value.reason == "queue_full"
                assert ei.value.tenant == (None if tenancy is None
                                           else "default")
                break
            sched.submit(side.sched.Request(rid=rid, prompt=_p(4),
                                            max_new_tokens=4))
        else:
            pytest.fail("max_waiting=2 never tripped")
        _run(sched)
        assert sched.engine.pool.in_use == 0


# -- quota floor and priority preemption --------------------------------------

def _floor(side):
    protos = [("gold", _p(8), 28)] + \
        [("batch", _p(16, seed=i), 20) for i in range(3)]

    def run_arm(num_pages, tenancy):
        sched = side.sched.ContinuousBatchingScheduler(
            _engine(side, num_pages=num_pages), clock=VClock(),
            tenancy=tenancy)
        reqs = [side.sched.Request(rid=i, prompt=prompt, max_new_tokens=new,
                                   tenant=name)
                for i, (name, prompt, new) in enumerate(protos)]
        for r in reqs:
            sched.submit(r)
        _run(sched)
        assert sched.engine.pool.in_use == 0
        return [(r.status, r.preemptions, r.generated) for r in reqs]

    reg = side.ten.TenantRegistry([
        side.ten.Tenant("gold", priority=1, guaranteed_pages=4),
        side.ten.Tenant("batch", priority=0)])
    return run_arm(13, reg), run_arm(200, None), reg.snapshot()


def test_quota_floor_never_preempted_and_identical_matches_jax(models):
    want, got = _both(models, _floor)
    assert got == want
    tight, roomy, snap = got
    assert snap["gold"]["preemptions"] == 0
    assert snap["batch"]["preemptions"] > 0
    assert 0 < snap["batch"]["preempted_cross"] <= snap["batch"][
        "preemptions"]
    assert all(s == "finished" for s, _, _ in tight + roomy)
    assert all(p == 0 for _, p, _ in roomy)
    assert [g for _, _, g in tight] == [g for _, _, g in roomy]


def _wfq_admission(side):
    """One tick's admission order under contention: 3 tenants with
    queued backlogs and a resident-page quota; the picks and the
    virtual times after each tick."""
    reg = side.ten.TenantRegistry([
        side.ten.Tenant("a", weight=2.0),
        side.ten.Tenant("b", weight=1.0, max_resident_pages=3),
        side.ten.Tenant("c", weight=1.0)])
    sched = side.sched.ContinuousBatchingScheduler(
        _engine(side, max_batch=3), clock=VClock(), tenancy=reg)
    rid = 0
    for name, n in (("b", 4), ("a", 4), ("c", 3)):
        for _ in range(n):
            sched.submit(side.sched.Request(
                rid=rid, prompt=_p(10, rid), max_new_tokens=5,
                tenant=name))
            rid += 1
    order = []
    while sched.has_work:
        before = {r.rid for r in sched.running}
        sched.step()
        order.append(sorted(r.rid for r in sched.running
                            if r.rid not in before))
    return order, reg.snapshot(), sched.engine.pool.in_use


def test_wfq_admission_order_matches_jax(models):
    want, got = _both(models, _wfq_admission)
    assert got == want
    order, snap, in_use = got
    assert sum(len(o) for o in order) >= 11 and in_use == 0
    assert snap["a"]["tokens"] > 0 and snap["c"]["tokens"] > 0


# -- the tenant on the router's journal ------------------------------------------

def _propagation(side):
    clk = VClock()
    regs = {}

    def treplica(name):
        def mk_sched(eng):
            reg = side.ten.TenantRegistry([side.ten.Tenant("acme",
                                                           weight=2.0)])
            regs[name] = reg
            return side.sched.ContinuousBatchingScheduler(
                eng, clock=clk, tenancy=reg)
        return side.replica.Replica(name, make_engine=lambda: _engine(side),
                                    make_scheduler=mk_sched, clock=clk)

    a, b = treplica("a"), treplica("b")
    router = side.router.ReplicaRouter(
        [a, b], clock=clk, cfg=side.router.RouterConfig(
            probe_interval_s=0.0, breaker_failures=1, breaker_reset_s=0.5))
    lr = router.submit_request(side.router.LogicalRequest(
        rid=1, prompt=_p(6), max_new_tokens=24, tenant="acme"))
    router.pump()
    for _ in range(3):
        a.tick()
    router.pump()
    a.wedge(3600.0)
    clk.t += 0.01
    router.pump()
    where = (lr.replica, lr.redispatches)
    router.run_until_done()
    return (where, lr.status, list(lr.delivered),
            {n: r.snapshot()["acme"] for n, r in regs.items()},
            a.engine.pool.in_use, b.engine.pool.in_use)


def test_tenant_propagation_across_router_redispatch_matches_jax(models):
    want, got = _both(models, _propagation)
    assert got == want
    where, status, delivered, snaps, a_use, b_use = got
    assert where == ("b", 1) and status == "finished"
    assert len(delivered) == 24
    assert snaps["b"]["admitted"] == 1 and snaps["b"]["tokens"] > 0
    assert a_use == b_use == 0


# -- observability surfaces ----------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _surfaces(side):
    clk = VClock()
    sched = side.sched.ContinuousBatchingScheduler(
        _engine(side), clock=clk, tenancy=side.ten.TenantRegistry(),
        slo=side.slo.SLOTracker(clock=clk))
    for rid in range(2):
        sched.submit(side.sched.Request(rid=rid, prompt=_p(4),
                                        max_new_tokens=4, tenant="x"))
    sched.submit(side.sched.Request(rid=2, prompt=_p(4), max_new_tokens=4))
    tens = sched._health_snapshot()["tenants"]
    _run(sched)
    sched.start_http(port=0)
    try:
        url = sched.http.url
        keyed = _get(url + "/slo?tenant=x")
        ghost = _get(url + "/slo?tenant=ghost")
        glob = _get(url + "/slo")
        health = _get(url + "/healthz")
    finally:
        sched.stop_http()
    view = side.ten.TenantSLOView(clock=VClock())
    unknown = view.snapshot_for("ghost")
    view.for_tenant("x").on_shed()
    return (tens, keyed, ghost, glob[0], health[1]["tenants"],
            unknown, view.snapshot_for("x")["known"],
            sched.engine.pool.in_use)


def test_healthz_tenants_and_keyed_slo_view_match_jax(models):
    want, got = _both(models, _surfaces)
    assert got == want
    tens, keyed, ghost, glob, htens, unknown, known, in_use = got
    assert tens["x"] == {"waiting": 2, "running": 0}
    assert tens["default"] == {"waiting": 1, "running": 0}
    assert keyed[0] == 200 and keyed[1]["tenant"] == "x"
    assert keyed[1]["known"] is True and "slis" in keyed[1]
    assert ghost == (200, {"tenant": "ghost", "known": False})
    assert glob == 200 and htens == {}
    assert unknown == {"tenant": "ghost", "known": False} and known
    assert in_use == 0
