"""The port's serving path against the JAX package's on a tiny GPT with
shared weights: the continuous-batching scheduler with and without
evictions, one teacher-forced packed prefill and decode step, and
greedy ``generate()``; plus the port's own allocator, scatter, intake,
deadline and anomaly-guard behaviour, and deadline admission control
against the JAX scheduler's."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.scheduler import RejectedError as JRejected
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu.serving.spec_decode import SpecDecodeConfig as JSpec
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PagedKVCache, PagePool, PagesExhausted,
                                      RejectedError, Request, ServingConfig,
                                      ServingEngine, SpecDecodeConfig,
                                      bucket_for)
from paddle_tpu_torch.serving.kv_cache import _scatter_pages
from paddle_tpu_torch.serving.tenancy import Tenant, TenantRegistry
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_CFG = dict(page_size=8, max_model_len=64, max_batch=8,
            max_prefill_tokens=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                       attention_dropout=0.0))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    tm = TM.GPTForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm


def _protos(vocab):
    rng = np.random.RandomState(1)
    return [(rng.randint(0, vocab, rng.randint(8, 24)).astype(np.int32),
             int(rng.randint(6, 18))) for _ in range(6)]


@pytest.mark.parametrize("num_pages", [200, 14])  # 14: forces evictions
def test_scheduler_tokens_match_jax(models, num_pages):
    jm, tm = models
    protos = _protos(tm.cfg.vocab_size)

    jeng = JEngine(jm, JConfig(**_CFG, num_pages=num_pages))
    js = JSched(jeng)
    for i, (p, n) in enumerate(protos):
        js.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
    js.run()

    teng = ServingEngine(tm, ServingConfig(**_CFG, num_pages=num_pages))
    ts = ContinuousBatchingScheduler(teng)
    for i, (p, n) in enumerate(protos):
        ts.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    ts.run()

    want = {r.rid: list(r.generated) for r in js.finished}
    got = {r.rid: list(r.generated) for r in ts.finished}
    assert got == want
    assert all(r.status == "finished" for r in ts.finished)
    assert teng.pool.in_use == 0, "leaked pages after completion"
    pre = sum(r.preemptions for r in ts.finished)
    assert pre == sum(r.preemptions for r in js.finished)
    if num_pages == 14:
        assert pre > 0, "tight pool never evicted: the case is vacuous"
    assert len(ts.prefill_calls) >= 1 and len(ts.decode_tick_ms) >= 1


def test_prefill_packed_and_decode_logits_match_jax(models):
    jm, tm = models
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, 1024, n).astype(np.int32) for n in (13, 30, 7)]
    jeng = JEngine(jm, JConfig(**_CFG))
    teng = ServingEngine(tm, ServingConfig(**_CFG))
    ps = _CFG["page_size"]
    pages = [jeng.pool.allocate(-(-(len(s) + 1) // ps)) for s in seqs]
    tpages = [teng.pool.allocate(-(-(len(s) + 1) // ps)) for s in seqs]
    assert pages == tpages   # same allocator, same page ids
    want = jeng.prefill_packed(seqs, pages)
    got = teng.prefill_packed(seqs, tpages)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # one teacher-forced decode step on top of the prefilled pages
    nxt = np.argmax(want, -1).astype(np.int32)
    pt = np.zeros((3, jeng.max_pages_per_seq), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    lens = np.asarray([len(s) for s in seqs], np.int32)
    want = jeng.decode(nxt, pt, lens)
    got = teng.decode(nxt, pt, lens)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_generate_matches_jax_greedy(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, 1024, (2, 8)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=6).numpy())
    got = tm.generate(ids, max_new_tokens=6).numpy()
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got, want)
    # a second call at the same buckets reuses the cached engine
    eng = list(tm._gen_engines.values())
    tm.generate(torch.from_numpy(ids), max_new_tokens=4)
    assert list(tm._gen_engines.values()) == eng
    assert eng[0].pool.in_use == 0


# -- the port's own allocator / scatter / intake invariants ------------------


def test_bucket_for_cap_is_top_bucket():
    assert bucket_for(3) == 4 and bucket_for(9, minimum=8) == 16
    assert bucket_for(130, minimum=32, maximum=192) == 192
    with pytest.raises(ValueError):
        bucket_for(200, maximum=128)


def test_page_pool_reserves_page_zero_and_guards_frees():
    pool = PagePool(num_pages=4, page_size=8)
    a = pool.allocate(3)
    assert 0 not in a and pool.available == 0
    with pytest.raises(PagesExhausted):
        pool.allocate(1)
    assert pool.in_use == 3   # a failed allocation takes nothing
    lid = pool.lease(a[:2], epoch=1)
    pool.free(a)              # two deferred under the lease
    assert pool.available == 1 and pool.in_use == 2
    assert sorted(pool.release_lease(lid)) == sorted(a[:2])
    assert pool.in_use == 0 and pool.available == 3
    with pytest.raises(ValueError):
        pool.free(a[:1])      # double free
    with pytest.raises(ValueError):
        pool.free([0])        # the reserved page was never allocated


def test_scatter_drops_oob_slots_in_place():
    kv = PagedKVCache(num_layers=1, num_pages=2, page_size=4,
                      num_kv_heads=1, head_dim=8, device="cpu")
    vals = torch.ones(1, 3, 1, 8)
    slots = torch.tensor([1, 5, 8])     # 8 >= 2*4: dropped
    _scatter_pages(kv.k_stores[0], vals, slots)
    pool = kv.k_pools[0]
    assert pool[0, 1].sum() == 8 and pool[1, 1].sum() == 8
    assert pool.sum() == 16             # exactly two slots written


def test_scheduler_intake_validation(models):
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(**_CFG, num_pages=6))
    # tenancy is ported: the registry's floors are validated against
    # the pool, as the JAX scheduler does
    with pytest.raises(ValueError, match="guaranteed_pages"):
        ContinuousBatchingScheduler(eng, tenancy=TenantRegistry(
            [Tenant("g", guaranteed_pages=4)]))
    ContinuousBatchingScheduler(eng, tenancy=TenantRegistry(),
                                prefill_only=True)
    s = ContinuousBatchingScheduler(eng, max_waiting=1)
    p = np.arange(10, dtype=np.int32)
    with pytest.raises(ValueError, match="max_model_len"):
        s.submit(Request(rid=0, prompt=p, max_new_tokens=60))
    with pytest.raises(ValueError, match="can never run"):
        s.submit(Request(rid=1, prompt=np.arange(40, dtype=np.int32),
                         max_new_tokens=20))
    s.submit(Request(rid=2, prompt=p, max_new_tokens=2))
    with pytest.raises(RejectedError):
        s.submit(Request(rid=3, prompt=p, max_new_tokens=2))
    assert s.cancel(2) and not s.has_work and eng.pool.in_use == 0


def test_deadlines_expire_queued_and_running_requests(models):
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(**{**_CFG, "max_batch": 2}))
    now = [0.0]
    s = ContinuousBatchingScheduler(eng, clock=lambda: now[0])
    p = np.arange(12, dtype=np.int32)
    s.submit(Request(rid=0, prompt=p, max_new_tokens=20, deadline_s=1.0))
    s.submit(Request(rid=1, prompt=p, max_new_tokens=3))
    s.submit(Request(rid=2, prompt=p, max_new_tokens=3, deadline_s=1.0))
    s.step()                       # two admitted (max_batch), one queued
    assert {r.rid for r in s.running} == {0, 1}
    assert [r.rid for r in s.waiting] == [2]
    now[0] = 2.0                   # rids 0 (running) and 2 (queued) expire
    s.run()
    status = {r.rid: r.status for r in s.finished}
    assert status == {0: "timeout", 1: "finished", 2: "timeout"}
    assert eng.pool.in_use == 0


def test_anomaly_guard_fails_only_the_poisoned_request(models):
    _, tm = models
    protos = _protos(tm.cfg.vocab_size)[:3]

    def run(poison_rid):
        eng = ServingEngine(tm, ServingConfig(**_CFG))
        s = ContinuousBatchingScheduler(eng)
        decode = eng.decode

        def poisoned(tokens, pt, lens):
            out = decode(tokens, pt, lens)
            runners = [r for r in s.running if r.status == "running"]
            for i, r in enumerate(runners):
                if r.rid == poison_rid and len(r.generated) == 3:
                    out = out.copy()
                    out[i] = np.nan
            return out

        eng.decode = poisoned
        for i, (p, n) in enumerate(protos):
            s.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        s.run()
        assert eng.pool.in_use == 0
        return {r.rid: (r.status, list(r.generated)) for r in s.finished}

    clean, hit = run(None), run(1)
    assert hit[1][0] == "error" and len(hit[1][1]) == 3
    for rid in (0, 2):   # batch-mates are bit-identical to the clean run
        assert hit[rid] == clean[rid] and clean[rid][0] == "finished"


def _admit(sched, req_cls, rid, prompt, max_new, deadline=None):
    """Submit one request: ``("admitted", None)`` or ``(reason,
    retry_after_s)`` of the rejection, and the request's status."""
    req = req_cls(rid=rid, prompt=prompt, max_new_tokens=max_new,
                  deadline_s=deadline)
    try:
        sched.submit(req)
        return ("admitted", None, req.status)
    except (RejectedError, JRejected) as e:
        return (e.reason, e.retry_after_s, req.status)


@pytest.mark.parametrize("case", [
    # (EMA s, max_waiting, admission_control, queued ahead, max_new,
    #  deadline s, expected outcome)
    (0.05, None, True, 2, 10, 0.1, "deadline_unmeetable"),
    (0.05, None, False, 2, 10, 0.1, "admitted"),
    (0.05, None, True, 2, 10, 1.0, "admitted"),
    (0.0, 1, True, 1, 4, None, "queue_full"),
    (0.004, 2, True, 2, 4, 0.5, "queue_full"),
    (1e-4, None, True, 0, 4, 1e-6, "deadline_unmeetable"),
])
def test_admission_control_matches_jax(models, case):
    """Deadline admission control is control flow: with the tick EMA set
    on both sides (as the JAX scheduler's virtual-clock tests do), the
    port sheds exactly the requests the JAX scheduler sheds, for the same
    reason and with the same ``retry_after_s``, floored at
    ``max(hint, ema, 1e-3)``."""
    ema, max_waiting, control, ahead, max_new, deadline, want = case
    jm, tm = models
    p = np.arange(10, dtype=np.int32)
    outcomes = []
    for sched_cls, eng, req_cls in (
            (JSched, JEngine(jm, JConfig(**_CFG)), JRequest),
            (ContinuousBatchingScheduler,
             ServingEngine(tm, ServingConfig(**_CFG)), Request)):
        s = sched_cls(eng, max_waiting=max_waiting,
                      admission_control=control)
        for i in range(ahead):
            s.submit(req_cls(rid=i, prompt=p, max_new_tokens=2))
        s._tick_s_ema = ema
        outcomes.append(_admit(s, req_cls, 99, p, max_new, deadline))
    assert outcomes[0] == outcomes[1]
    reason, retry, status = outcomes[1]
    assert reason == want
    if want == "admitted":
        assert status == "waiting" and retry is None
    else:
        assert status == "rejected"
        hint = ema * ahead
        assert retry == max(hint, ema, 1e-3)


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "verify"])
def test_tick_ema_follows_decode_and_verify_ticks(models, spec):
    """The EMA starts at 0 and is set by the first decode tick (plain) or
    verify tick (speculative) on both sides; a request whose deadline is
    below one tick is then shed on both."""
    class Always:                       # drafts on every tick
        def propose(self, ctx, budget):
            return [1] * max(0, budget)

    jm, tm = models
    prompt = np.arange(20, dtype=np.int32)
    for sched_cls, eng, req_cls, cfg in (
            (JSched, JEngine(jm, JConfig(**_CFG)), JRequest, JSpec),
            (ContinuousBatchingScheduler,
             ServingEngine(tm, ServingConfig(**_CFG)), Request,
             SpecDecodeConfig)):
        s = sched_cls(eng, spec_decode=cfg(k=4) if spec else None,
                      drafter=Always() if spec else None)
        calls = {"decode": 0, "verify": 0}
        for name in calls:
            def counted(*a, _fn=getattr(eng, name), _name=name):
                calls[_name] += 1
                return _fn(*a)
            setattr(eng, name, counted)
        assert s._tick_s_ema == 0.0
        s.submit(req_cls(rid=0, prompt=prompt, max_new_tokens=8))
        s.step()
        assert calls == ({"decode": 0, "verify": 1} if spec
                         else {"decode": 1, "verify": 0})
        assert s._tick_s_ema > 0.0
        reason, retry, status = _admit(s, req_cls, 1, prompt, 8,
                                       deadline=s._tick_s_ema / 2)
        assert (reason, status) == ("deadline_unmeetable", "rejected")
        assert retry == max(s._tick_s_ema, 1e-3)
