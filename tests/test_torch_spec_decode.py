"""The port's speculative decoding against the JAX package's on shared
inputs: the multi-query verify window's plain version (K-MQ's) against
the Pallas ``_mq_kernel`` in interpret mode and its XLA reference, the
n-gram drafter and the repetitious trace, the engine's ``verify`` step,
and the scheduler's draft->verify->accept loop on a tiny GPT with JAX
weights carried across (roomy and evicting pools, mixed sampling, the
drafter's budget)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.ops.pallas.paged_attention import (
    paged_multiquery_attention as jax_mq_kernel)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_multiquery_attention_xla)
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.loadgen import repetitious_trace as jax_trace
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu.serving.spec_decode import NgramDrafter as JDrafter
from paddle_tpu.serving.spec_decode import SpecDecodeConfig as JSpec
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      NgramDrafter, Request, ServingConfig,
                                      ServingEngine, SpecDecodeConfig,
                                      repetitious_trace)
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_CFG = dict(page_size=8, max_model_len=64, max_batch=8,
            max_prefill_tokens=128)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _paged_inputs(rng, b, qlen, nh, nh_kv, d, ps, npages, maxp):
    q = rng.randn(b, qlen, nh, d).astype(np.float32)
    kp = rng.randn(npages, ps, nh_kv * d).astype(np.float32)
    vp = rng.randn(npages, ps, nh_kv * d).astype(np.float32)
    # random non-contiguous page tables; lens: a window shorter than
    # qlen, a padding row, a full row and a ragged one
    pt = np.stack([rng.permutation(npages)[:maxp]
                   for _ in range(b)]).astype(np.int32)
    lens = np.asarray([max(1, qlen - 2), 0, maxp * ps,
                       rng.randint(qlen, maxp * ps)], np.int32)
    return q, kp, vp, pt, lens


@pytest.mark.parametrize("qlen", [1, 3, 5])
@pytest.mark.parametrize("nh,nh_kv", [(4, 4), (4, 2), (4, 1)])
def test_multiquery_ref_matches_jax(qlen, nh, nh_kv):
    rng = np.random.RandomState(qlen * 10 + nh_kv)
    q, kp, vp, pt, lens = _paged_inputs(rng, 4, qlen, nh, nh_kv, 16, 8,
                                        12, 4)
    args = [jnp.asarray(x) for x in (q, kp, vp, pt, lens)]
    want_kernel = np.asarray(jax_mq_kernel(*args, interpret=True))
    want_xla = np.asarray(paged_multiquery_attention_xla(*args))
    K.reset_launch_counts()
    targs = [_t(x) for x in (q, kp, vp, pt, lens)]
    for got in (pa.paged_multiquery_attention_ref(*targs),
                pa.paged_multiquery_attention(*targs),
                disp.paged_multiquery_attention(*targs)):
        got = got.numpy()
        assert got.shape == q.shape
        np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
        assert np.all(got[1] == 0.0)        # seq_len 0 padding row
        # rows that see no key (a window longer than the context) -> 0
        assert np.all(got[0, :qlen - lens[0]] == 0.0)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    if qlen == 1:   # an empty draft is the decode step, bit for bit
        dec = pa.paged_attention_ref(targs[0][:, 0], *targs[1:])
        assert torch.equal(pa.paged_multiquery_attention_ref(*targs)[:, 0],
                           dec)


def test_multiquery_wrapper_takes_at_most_eight_rows_on_cuda():
    meta = torch.device("meta")
    pool = torch.empty(3, 8, 256, device=meta)
    pt = torch.empty(2, 2, dtype=torch.int32, device=meta)
    sl = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="qlen <= 8"):
        pa.paged_multiquery_attention(
            torch.empty(2, 9, 4, 64, device=meta), pool, pool, pt, sl)


# -- the drafter and the trace ------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for k, lo, hi in ((4, 1, 3), (2, 1, 1), (6, 2, 4)):
        ours, theirs = NgramDrafter(k, hi, lo), JDrafter(k, hi, lo)
        for _ in range(40):
            n = int(rng.randint(0, 40))
            if rng.rand() < 0.5:   # cyclic: a phrase tiled, then cut
                phrase = rng.randint(0, 9, rng.randint(1, 6)).tolist()
                ctx = (phrase * 10)[:n]
            else:                  # random over a small vocabulary
                ctx = rng.randint(0, 6, n).tolist()
            budget = int(rng.randint(-1, 8))
            got = ours.propose(ctx, budget)
            assert got == theirs.propose(ctx, budget), (ctx, budget)
            assert len(got) <= max(0, min(k, budget))
    with pytest.raises(ValueError):
        SpecDecodeConfig(k=0)
    with pytest.raises(ValueError):
        SpecDecodeConfig(min_ngram=3, max_ngram=2)


@pytest.mark.parametrize("kw", [
    {}, dict(rate_rps=4.0, deadline_s=2.5),
    dict(phrase_lens=(16, 64), repeats=(4, 12), out_tokens=(32, 128),
         vocab_size=50304)])
def test_repetitious_trace_matches_jax(kw):
    for seed in (0, 15):
        ours, theirs = repetitious_trace(9, seed=seed, **kw), jax_trace(
            9, seed=seed, **kw)
        assert len(ours) == len(theirs) == 9
        for a, b in zip(ours, theirs):
            assert a.rid == b.rid and a.max_new_tokens == b.max_new_tokens
            assert a.prompt.dtype == np.int32
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert (a.arrival_s, a.deadline_s) == (b.arrival_s, b.deadline_s)


# -- the engine's verify step and the scheduler -------------------------------


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


def test_verify_logits_match_jax(models):
    """A packed prefill, then a verify window of 5 on top of it, the last
    row of one request running past the table's reach (dropped)."""
    jm, tm = models
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, 1024, n).astype(np.int32) for n in (13, 30, 60)]
    jeng = JEngine(jm, JConfig(**_CFG))
    teng = ServingEngine(tm, ServingConfig(**_CFG))
    ps, w = _CFG["page_size"], 5
    pages = [jeng.pool.allocate(min(8, -(-(len(s) + w) // ps)))
             for s in seqs]
    assert pages == [teng.pool.allocate(len(p)) for p in pages]
    np.testing.assert_allclose(teng.prefill_packed(seqs, pages),
                               jeng.prefill_packed(seqs, pages),
                               rtol=0, atol=1e-4)
    pt = np.zeros((3, jeng.max_pages_per_seq), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    lens = np.asarray([len(s) for s in seqs], np.int32)
    win = rng.randint(0, 1024, (3, w)).astype(np.int32)
    want = jeng.verify(win, pt, lens)
    got = teng.verify(win, pt, lens)
    assert got.shape == (3, w, tm.cfg.vocab_size)
    # rows 0-3 of request 2 lie inside its 64-token table; row 4 drops
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-4)


def test_verify_of_one_row_is_the_decode_step(models):
    _, tm = models
    rng = np.random.RandomState(5)
    seqs = [rng.randint(0, 1024, n).astype(np.int32) for n in (9, 17)]
    out = []
    for step in ("decode", "verify"):
        eng = ServingEngine(tm, ServingConfig(**_CFG))
        pages = [eng.pool.allocate(4) for _ in seqs]
        nxt = np.argmax(eng.prefill_packed(seqs, pages), -1).astype(np.int32)
        pt = np.zeros((2, eng.max_pages_per_seq), np.int32)
        for i, pg in enumerate(pages):
            pt[i, :4] = pg
        lens = np.asarray([len(s) for s in seqs], np.int32)
        out.append(eng.decode(nxt, pt, lens) if step == "decode"
                   else eng.verify(nxt[:, None], pt, lens)[:, 0])
    np.testing.assert_array_equal(out[0], out[1])


def _protos(vocab, n=6, seed=3):
    """Repetitious prompts with mixed output budgets (as the JAX
    package's spec-decode drill)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        phrase = rng.randint(0, vocab, rng.randint(3, 6))
        out.append((np.tile(phrase, rng.randint(3, 5)).astype(np.int32),
                    int(rng.randint(6, 18))))
    return out


def _run(engine_cls, cfg_cls, sched_cls, req_cls, model, protos, num_pages,
         spec):
    eng = engine_cls(model, cfg_cls(**_CFG, num_pages=num_pages))
    sched = sched_cls(eng, spec_decode=spec)
    for i, (p, n) in enumerate(protos):
        sched.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
    sched.run()
    assert eng.pool.in_use == 0, "leaked pages after completion"
    return sched


@pytest.mark.parametrize("num_pages", [200, 14])  # 14: forces evictions
def test_spec_scheduler_matches_jax(models, num_pages):
    jm, tm = models
    protos = _protos(tm.cfg.vocab_size)
    js = _run(JEngine, JConfig, JSched, JRequest, jm, protos, num_pages,
              JSpec(k=4))
    ts = _run(ServingEngine, ServingConfig, ContinuousBatchingScheduler,
              Request, tm, protos, num_pages, SpecDecodeConfig(k=4))
    plain = _run(ServingEngine, ServingConfig, ContinuousBatchingScheduler,
                 Request, tm, protos, num_pages, None)

    def streams(s):
        return {r.rid: (list(r.generated), r.spec_proposed, r.spec_accepted,
                        r.status) for r in s.finished}

    assert streams(ts) == streams(js)
    assert ({r.rid: r.generated for r in ts.finished}
            == {r.rid: r.generated for r in plain.finished})
    pre = sum(r.preemptions for r in ts.finished)
    assert pre == sum(r.preemptions for r in js.finished)
    if num_pages == 14:
        assert pre > 0, "tight pool never evicted: the case is vacuous"
    accepted = sum(r.spec_accepted for r in ts.finished)
    assert accepted > 0 and ts.verify_ticks, "speculation never engaged"
    # the host records: (ms, committed, proposed, accepted) per verify tick
    assert sum(v[3] for v in ts.verify_ticks) == accepted
    assert sum(v[2] for v in ts.verify_ticks) == sum(
        r.spec_proposed for r in ts.finished)
    committed = sum(v[1] for v in ts.verify_ticks) + sum(
        1 for _ in ts.decode_tick_ms)
    assert committed <= sum(len(r.generated) - 1 for r in ts.finished)


def test_spec_with_sampling_requests_mixed(models):
    """A sampling request rides the window as a plain decode row: never
    drafted for, and its sampled tokens equal the JAX scheduler's (the
    engines share their seeded numpy sampler)."""
    jm, tm = models
    phrase = np.tile(np.arange(4, dtype=np.int32), 4)
    done = []
    for eng_cls, cfg_cls, sched_cls, req_cls, model, spec in (
            (JEngine, JConfig, JSched, JRequest, jm, JSpec(k=4)),
            (ServingEngine, ServingConfig, ContinuousBatchingScheduler,
             Request, tm, SpecDecodeConfig(k=4))):
        eng = eng_cls(model, cfg_cls(**{**_CFG, "max_batch": 4}))
        sched = sched_cls(eng, spec_decode=spec)
        sched.submit(req_cls(rid=0, prompt=phrase, max_new_tokens=8))
        sched.submit(req_cls(rid=1, prompt=phrase, max_new_tokens=8,
                             temperature=0.8, top_k=5))
        sched.run()
        assert eng.pool.in_use == 0
        done.append({r.rid: r for r in sched.finished})
    j, t = done
    assert len(t[0].generated) == len(t[1].generated) == 8
    assert t[1].spec_proposed == 0   # the sampling lane is never drafted
    assert t[0].spec_proposed > 0
    for rid in (0, 1):
        assert t[rid].generated == j[rid].generated


def test_drafter_never_gets_a_budget_past_remaining(models):
    _, tm = models
    calls = []

    class SpyDrafter(NgramDrafter):
        def propose(self, tokens, max_tokens):
            req = next(r for r in sched.running
                       if r.prompt.tolist() + r.generated == list(tokens))
            calls.append((int(max_tokens),
                          req.max_new_tokens - len(req.generated) - 1))
            return super().propose(tokens, max_tokens)

    eng = ServingEngine(tm, ServingConfig(**{**_CFG, "max_batch": 4}))
    sched = ContinuousBatchingScheduler(eng, drafter=SpyDrafter(k=4))
    assert sched.spec.k == 4
    phrase = np.tile(np.arange(5, dtype=np.int32), 4)
    for rid, n in enumerate((3, 7)):
        sched.submit(Request(rid=rid, prompt=phrase + rid,
                             max_new_tokens=n))
    sched.run()
    assert eng.pool.in_use == 0
    assert calls and all(0 < got <= rem for got, rem in calls), calls
    assert {r.rid: len(r.generated) for r in sched.finished} == {0: 3, 1: 7}
    # past its deadline a request is never drafted for
    s2 = ContinuousBatchingScheduler(eng, drafter=SpyDrafter(k=4))
    sched = s2
    r = Request(rid=2, prompt=phrase, max_new_tokens=8)
    s2.submit(r)
    s2.step()                          # prefill, then a first tick
    r.t_deadline = s2.clock() - 1.0
    calls.clear()
    s2._decode_spec()
    assert calls == [], "drafted past a request's deadline"
    s2.run()
    assert eng.pool.in_use == 0
