"""The port's load generation against the JAX package's on the CPU: every
trace family gives the same requests per seed, element for element; the
prompt-length report, the nearest-rank percentile and the retry policy's
delays agree; and ``run_continuous`` (with and without a retrying client,
with tenants) and ``run_static_baseline`` give the same token streams and
the same report, key for key, with exact counts, on a tiny GPT with
shared weights. Only the report's time fields are left out."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.serving import loadgen as JL
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.tenancy import Tenant as JTenant
from paddle_tpu.serving.tenancy import TenantRegistry as JRegistry
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.serving import loadgen as TL
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      ServingConfig, ServingEngine, Tenant,
                                      TenantRegistry)
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_TINY = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
             max_position_embeddings=64, hidden_dropout=0.0,
             attention_dropout=0.0)
_SERVING = dict(page_size=8, max_model_len=64, max_batch=8,
                max_prefill_tokens=128)
# the report's fields that read the clock; every other field is exact
_TIME_FIELDS = {"decode_tokens_per_sec", "goodput_tokens_per_sec",
                "requests_per_sec", "wall_s", "latency_ms_p50",
                "latency_ms_p99", "ttft_ms_p50", "ttft_ms_p99",
                "itl_ms_p50", "itl_ms_p99"}


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


def _engines(models, **kw):
    jm, tm = models
    cfg = {**_SERVING, **kw}
    return JEngine(jm, JConfig(**cfg)), ServingEngine(tm, ServingConfig(
        **cfg))


class StepClock:
    """A virtual clock that moves ``dt`` on every read: arrivals and
    retries fall due in a fixed number of reads, whatever the host's
    speed."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _fields(r):
    return (r.rid, r.prompt.tolist(), r.prompt.dtype.str, r.max_new_tokens,
            r.arrival_s, r.deadline_s, r.tenant, r.temperature, r.top_k)


_TRACES = [
    ("synthetic_trace", (24,), dict(seed=0)),
    ("synthetic_trace", (24,), dict(seed=7, rate_rps=5.0, deadline_s=2.5)),
    ("synthetic_trace", (16,), dict(seed=3, prompt_lens=(4, 12),
                                   short_out=(6, 12), long_out=(16, 24),
                                   vocab_size=128)),
    ("repetitious_trace", (12,), dict(seed=2, rate_rps=3.0)),
    ("long_prompt_trace", (24,), dict(seed=1)),
    ("long_prompt_trace", (24,), dict(seed=5, rate_rps=8.0,
                                     long_frac=0.5, deadline_s=1.0)),
    ("multi_tenant_trace", (6,), dict(seed=3, base_rate_rps=4.0)),
    ("multi_tenant_trace", (5,), dict(seed=1, base_rate_rps=None,
                                     tenants=(("gold", 1.0),
                                              ("batch", 3.0)))),
]


@pytest.mark.parametrize("name,args,kw", _TRACES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(_TRACES)])
def test_traces_match_jax(name, args, kw):
    want = [_fields(r) for r in getattr(JL, name)(*args, **kw)]
    got = [_fields(r) for r in getattr(TL, name)(*args, **kw)]
    assert got == want and len(got) > 0


def test_prompt_length_report_percentile_and_retry_delays_match_jax():
    trace = TL.long_prompt_trace(40, seed=9)
    assert TL.prompt_length_report(trace) == JL.prompt_length_report(
        JL.long_prompt_trace(40, seed=9))
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 7, 100):
        xs = rng.rand(n).tolist()
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert TL.percentile(xs, q) == JL.percentile(xs, q)
    jp, tp = JL.RetryPolicy(seed=4), TL.RetryPolicy(seed=4)
    jr, tr = (np.random.RandomState(p.seed) for p in (jp, tp))
    want = [jp.delay_s(a, h, jr) for a in (1, 2, 3, 4, 6)
            for h in (0.0, 0.01, 0.3)]
    got = [tp.delay_s(a, h, tr) for a in (1, 2, 3, 4, 6)
           for h in (0.0, 0.01, 0.3)]
    assert got == want


def _same_report(got, want):
    assert set(got) == set(want)
    strip = {k: v for k, v in got.items() if k not in _TIME_FIELDS
             and k != "tenants"}
    assert strip == {k: v for k, v in want.items()
                     if k not in _TIME_FIELDS and k != "tenants"}
    if "tenants" in want:
        tt, jt = got["tenants"], want["tenants"]
        assert set(tt) == set(jt)
        for name in jt:
            assert set(tt[name]) == set(jt[name])
            keep = ("requests", "completed", "rejected", "tokens",
                    "preemptions")
            assert {k: tt[name][k] for k in keep} == \
                {k: jt[name][k] for k in keep}


def _streams(reqs):
    return {r.rid: (r.status, list(r.generated)) for r in reqs}


@pytest.mark.parametrize("num_pages", [None, 12], ids=["roomy", "evicting"])
def test_run_continuous_matches_jax(models, num_pages):
    jeng, teng = _engines(models, num_pages=num_pages)
    trace_kw = dict(seed=3, prompt_lens=(4, 24), short_out=(4, 10),
                    long_out=(16, 30), vocab_size=64)
    jtrace = JL.synthetic_trace(12, **trace_kw)
    ttrace = TL.synthetic_trace(12, **trace_kw)
    want = JL.run_continuous(jeng, jtrace, clock=StepClock())
    got = TL.run_continuous(teng, ttrace, clock=StepClock())
    _same_report(got, want)
    assert got["completed"] == 12 and got["kv_pages"] == jeng.kv.num_pages
    assert _streams(ttrace) == _streams(jtrace)
    if num_pages:
        assert got["preemptions"] > 0, "the tight pool never evicted"
    assert teng.pool.in_use == 0


def test_run_continuous_retry_matches_jax(models):
    """A bounded queue sheds part of a burst; the retrying client
    resubmits each shed request after its hint, and gives up after
    ``max_retries``: the same sheds, retries, give-ups and streams."""
    jeng, teng = _engines(models, max_batch=2)
    trace_kw = dict(seed=5, prompt_lens=(4, 16), short_out=(3, 6),
                    long_out=(8, 12), vocab_size=64)
    out = []
    for L, eng, sched_cls in ((JL, jeng, JSched),
                              (TL, teng, ContinuousBatchingScheduler)):
        # a read moves the clock past any hint a host-timed tick gives,
        # so every retry falls due at the client's next pass
        clk = StepClock(10.0)
        trace = L.synthetic_trace(10, **trace_kw)
        sched = sched_cls(eng, clock=clk, max_waiting=2,
                          admission_control=False)
        rep = L.run_continuous(eng, trace, clock=clk, scheduler=sched,
                               retry=L.RetryPolicy(max_retries=2, seed=1))
        out.append((rep, trace))
    (want, jtrace), (got, ttrace) = out
    _same_report(got, want)
    assert got["retried"] > 0 and got["rejected"] > 0
    assert got["retry_gave_up"] == got["rejected"]
    assert _streams(ttrace) == _streams(jtrace)
    assert teng.pool.in_use == 0


def test_run_continuous_tenants_match_jax(models):
    """``multi_tenant_trace`` through a tenancy scheduler: the report's
    per-tenant block (requests, completions, sheds, tokens,
    preemptions) and every stream equal the JAX run's."""
    jeng, teng = _engines(models, num_pages=16)
    out = []
    for L, eng, sched_cls, T, R in (
            (JL, jeng, JSched, JTenant, JRegistry),
            (TL, teng, ContinuousBatchingScheduler, Tenant,
             TenantRegistry)):
        clk = StepClock(0.01)
        reg = R([T("flood", rate_tokens_per_s=60.0, burst_tokens=80.0),
                 T("steady", weight=2.0, priority=1)])
        trace = L.multi_tenant_trace(6, seed=2, base_rate_rps=None,
                                     vocab_size=64)
        sched = sched_cls(eng, clock=clk, tenancy=reg)
        out.append((L.run_continuous(eng, trace, clock=clk,
                                     scheduler=sched), trace,
                    reg.snapshot()))
    (want, jtrace, jsnap), (got, ttrace, tsnap) = out
    _same_report(got, want)
    assert got["tenants"]["flood"]["rejected"] > 0
    assert _streams(ttrace) == _streams(jtrace)
    assert tsnap == jsnap
    assert teng.pool.in_use == 0


def test_run_static_baseline_matches_jax(models):
    jeng, teng = _engines(models)
    trace_kw = dict(seed=8, prompt_lens=(4, 20), short_out=(4, 8),
                    long_out=(12, 20), vocab_size=64)
    jtrace = JL.synthetic_trace(11, **trace_kw)
    ttrace = TL.synthetic_trace(11, **trace_kw)
    want = JL.run_static_baseline(jeng, jtrace, batch_size=4,
                                  clock=StepClock())
    got = TL.run_static_baseline(teng, ttrace, batch_size=4,
                                 clock=StepClock())
    _same_report(got, want)
    assert got["mode"] == "static" and got["completed"] == 11
    assert _streams(ttrace) == _streams(jtrace)
    assert all(len(r.generated) == r.max_new_tokens for r in ttrace)
    assert teng.pool.in_use == 0
